#!/usr/bin/env python3
"""Read the checks of ``chip_smoke.py`` phase 16 (the chunk scan's
backward) on the sound kernels and under planted faults, to place the
bf16 limits between the two.

    python3 tools/ssd_margins.py [--seeds 0 1 2] [--no-models]

A planted fault changes what the backward's stages hand each other, in
their Python composition (``ssd_scan.ssd_scan_bwd_cuda``); the kernel
sources are not touched:

* ``no_state_pass``: the reverse state pass's Q and end-state products
  set to zero (Q_c = 0: no gradient crosses a chunk boundary);
* ``dcs_shift``: dcs shifted by one row inside each chunk (da_k read from
  row k + 1, the last row's 0: the reverse cumsum's off-by-one).

The script prints, on every seed sound and with each fault:

* each 16a row (``SSD_BWD_SHAPES``): per gradient tensor, max |diff| /
  max |grad| against the plain backward and against the float64 chunked
  form (``ssd_bwd_check``'s readings, not held to a limit here);

and, unless ``--no-models``, sound on every seed and with each fault on
the first:

* 16b's gradient gate at mamba2-130m's full width and depth, in bf16 and
  float32 (the largest over the parameters of max |diff| / max |grad|).

It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)

FAULTS = ("no_state_pass", "dcs_shift")


@contextlib.contextmanager
def planted(fault: str | None):
    """Inside, every backward of the chunk scan runs with ``fault``
    planted between its stages (None: sound)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    state_pass, chunk_scan = sk.state_pass_bwd_cuda, sk.chunk_scan_bwd_cuda

    def no_state_pass(*args):
        q, end = state_pass(*args)
        return q.zero_(), end.zero_()

    def dcs_shift(*args):
        dx, dBh, dCh, da = chunk_scan(*args)
        shifted = torch.zeros_like(da)
        shifted[..., :-1] = da[..., 1:]
        return dx, dBh, dCh, shifted
    if fault == "no_state_pass":
        sk.state_pass_bwd_cuda = no_state_pass
    elif fault == "dcs_shift":
        sk.chunk_scan_bwd_cuda = dcs_shift
    try:
        yield
    finally:
        sk.state_pass_bwd_cuda, sk.chunk_scan_bwd_cuda = state_pass, chunk_scan


def kernel_rows(dev, seeds, faults) -> None:
    import torch
    limits = dict(cs.SSD_BWD_TOL)
    cs.SSD_BWD_TOL.update(float32=float("inf"), bfloat16=float("inf"))
    try:
        for seed in seeds:
            for fault in (None, *faults):
                for tag in cs.SSD_BWD_SHAPES:
                    with planted(fault):
                        r = cs.ssd_bwd_check(tag, dev, seed, False)
                    torch.cuda.empty_cache()
                    print(f"margins 16a seed {seed} {fault or 'sound'} {tag}: "
                          + ", ".join(f"{n} {v[0]:.4g} / {v[1]:.4g} ({v[2]})"
                                      for n, v in r["reads"].items()),
                          flush=True)
    finally:
        cs.SSD_BWD_TOL.update(limits)
    print(f"margins 16a limits: {limits}")


def train_gates(dev, seeds, faults) -> None:
    runs = [(s, None) for s in seeds] + [(seeds[0], f) for f in faults]
    for seed, fault in runs:
        with planted(fault):
            *_, reads = cs.mamba_train_gates(dev, seed, check=False)
        print(f"margins 16b seed {seed} {fault or 'sound'}: gradient gate "
              + ", ".join(f"{k} {v:.4g}" for k, v in reads.items())
              + f" (limits {cs.MAMBA_TRAIN_GRAD_TOL})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--faults", nargs="+", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--no-models", action="store_true",
                    help="skip the 16b gradient gates")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_margins: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build_all(["ssd_scan", "ssd_scan_bwd"])
    dev = torch.device("cuda")
    print(f"card: {cs.gpu_name_and_power_limit()}", flush=True)
    kernel_rows(dev, args.seeds, args.faults)
    if not args.no_models:
        train_gates(dev, args.seeds, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
