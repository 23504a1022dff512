#!/usr/bin/env python3
"""Read the bf16 attention checks of ``chip_smoke.py`` on the sound
kernels and on kernels with a planted fault, to place each limit between
the two.

    python3 tools/attention_margins.py [--seeds 0 1 2]
        [--faults 1.005 1.01 0.99] [--no-models] [--backward]

A planted fault multiplies the softmax scale that the decode_attention and
flash_attention wrappers hand their kernels by a factor (the launches'
one float argument; the sources are not touched).  The script prints, on
every seed sound and with each fault:

* each kernel row of ``chip_smoke.py`` (``DECODE_SHAPES`` and
  ``FLASH_SHAPES`` at each window): the kernel against the plain
  version's float32 output, max |diff| / max |out| of a query (held at
  ``BF16_REL_TOL``) and over the whole output (``rel_errs``);

and, unless ``--no-models``, sound on every seed and with each fault on
the first:

* deepseek-v2-lite-16b's bf16 teacher-forced gate at full width and
  depth, the kernels run on the plain run's expert picks
  (``moe_gate(pin=True)``, held at ``MOE_BF16_TOL``);
* h2o-danube-3-4b's bf16 ring step at full width, kernels against plain
  (``ring_step`` on ``danube_rings``, held at ``RING_BF16_TOL``).

With ``--backward`` it reads the checks of phase 15 instead:

* each 15a row (``BWD_SHAPES`` at each dtype), the instance named: the
  forward kernel's saved log-sum-exp against ``attention_lse_ref``, max
  |diff| (held at ``LSE_TOL``), with the fault planted in the forward's
  launches; then the backward kernel, fed the sound forward's
  log-sum-exp, against the plain version's float32 gradients, the
  largest over dq, dk and dv of max |diff| / max |ref| of a row (held at
  ``BWD_TOL``), with the fault planted in the backward's launches alone
  (the tensor-core or CUDA-core entry points, whichever the dispatch
  takes);

and, unless ``--no-models``, sound on every seed and with each fault on
the first:

* 15b's gradient gate at llama3-8b's width and ``TRAIN_LAYERS`` layers,
  in bf16 and float32 (held at ``TRAIN_GRAD_TOL``).

It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


class Faulty:
    """A kernel library whose ``*_launch`` entry points get every float
    argument (the softmax scale) times ``factor``."""

    def __init__(self, lib, factor: float):
        self.lib, self.factor = lib, factor

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.endswith("_launch"):
            return fn
        return lambda *a: fn(*(x * self.factor if isinstance(x, float)
                               else x for x in a))


@contextlib.contextmanager
def scale_fault(factor: float):
    """Inside, every decode_attention and flash_attention forward launch
    runs with its softmax scale times ``factor``."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention as fa
    saved = da._lib, fa._lib
    da._lib = lambda: Faulty(saved[0](), factor)
    fa._lib = lambda: Faulty(saved[1](), factor)
    try:
        yield
    finally:
        da._lib, fa._lib = saved


@contextlib.contextmanager
def backward_fault(factor: float):
    """Inside, both flash backward launches run with their softmax scale
    times ``factor``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    saved = fa._bwd_lib
    fa._bwd_lib = lambda: Faulty(saved(), factor)
    try:
        yield
    finally:
        fa._bwd_lib = saved


def backward_rows(dev, seeds, faults) -> None:
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    for tag, shape in cs.BWD_SHAPES.items():
        window = shape[6]
        for dtype in shape[-1]:
            for seed in seeds:
                inputs = cs.bwd_inputs(dev, seed, tag, getattr(torch, dtype))
                lse_cells = []
                for factor in (1.0, *faults):
                    with scale_fault(factor):
                        _, inst, err = cs.kernel_lse(inputs, window)
                    lse_cells.append(f"x{factor:g} {err:.3g}")
                lse = cs.kernel_lse(inputs, window)[0]
                ref = attention_bwd_ref(*(x.float() for x in inputs),
                                        causal=True, window=window)
                cells = []
                for factor in (1.0, *faults):
                    with backward_fault(factor):
                        got = fa.flash_attention_bwd_cuda(
                            *inputs, lse, causal=True, window=window)
                    torch.cuda.synchronize()
                    reads = [cs.grad_rel_errs(a, b) for a, b in zip(got, ref)]
                    cells.append(f"x{factor:g} " + "/".join(
                        f"{r[0]:.4g}" for r in reads))
                    del got
                del ref, inputs, lse
                print(f"flash_attention_bwd {tag} {dtype} seed {seed} "
                      f"({inst} instance): forward log-sum-exp max |diff| "
                      f"vs plain: {'; '.join(lse_cells)} [limit "
                      f"{cs.LSE_TOL:g}]; backward max |diff| / max |ref| of "
                      f"a row, dq/dk/dv, vs float32 plain: "
                      f"{'; '.join(cells)} [limit {cs.BWD_TOL[dtype]:g}]",
                      flush=True)
                torch.cuda.empty_cache()


def train_gates(dev, seeds, faults) -> None:
    import torch
    for seed in seeds:
        for factor in (1.0, *(faults if seed == seeds[0] else ())):
            with backward_fault(factor):
                reads = cs.train_gates(dev, seed, check=False)[-1]
            print(f"15b gradient gate seed {seed} x{factor:g}: "
                  f"{', '.join(f'{k} {v:.4g}' for k, v in reads.items())} "
                  f"[limits {cs.TRAIN_GRAD_TOL}]", flush=True)
            torch.cuda.empty_cache()


def kernel_rows(dev, seeds, faults) -> None:
    import torch
    for kernel, shapes in (("decode_attention", cs.DECODE_SHAPES),
                           ("flash_attention", cs.FLASH_SHAPES)):
        for tag, shape in shapes.items():
            for window in shape[-1]:
                for seed in seeds:
                    inputs = cs.attention_inputs(dev, seed, kernel, tag)
                    kern, _, plain32, _, _ = cs.attention_calls(
                        kernel, inputs, window)
                    ref = plain32()
                    cells = []
                    for factor in (1.0, *faults):
                        with scale_fault(factor):
                            got = kern()
                        torch.cuda.synchronize()
                        rel, rel_all = cs.rel_errs(got, ref)
                        cells.append(f"x{factor:g} {rel:.4g} ({rel_all:.4g})")
                        del got
                    del ref, inputs
                    print(f"{kernel} {tag} window={window} seed {seed}: max "
                          f"|diff| / max |out| a query (over the whole "
                          f"output) vs float32 plain: "
                          f"{'; '.join(cells)} [limit "
                          f"{cs.BF16_REL_TOL[kernel]:g}]", flush=True)
                torch.cuda.empty_cache()


def deepseek_gates(dev, seeds, faults) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("deepseek-v2-lite-16b")
    for seed in seeds:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
        # chip_smoke.deepseek_path's first draw of its generator
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            1, cfg.vocab_size, (1, cs.MOE_GATE_TOKENS)).astype(np.int64)
        ).to(dev)
        for factor in (1.0, *(faults if seed == seeds[0] else ())):
            with scale_fault(factor):
                r = cs.moe_gate(cfg, params, prompt, pin=True)
            print(f"deepseek bf16 pinned gate seed {seed} x{factor:g}: "
                  f"decode {r['kernels']:.4g}, prefill {r['prefill']:.4g} "
                  f"[limit {cs.MOE_BF16_TOL:g}]", flush=True)
        del params
        torch.cuda.empty_cache()


def ring_steps(dev, seeds, faults) -> None:
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as da
    counters = {"decode_attention": da.launches}
    for seed in seeds:
        cfg, _, params, rings, tok, pos = cs.danube_rings(dev, seed)
        for factor in (1.0, *(faults if seed == seeds[0] else ())):
            with scale_fault(factor):
                rel, _ = cs.ring_step(cfg, params, rings, tok, pos, counters,
                                      da.launches.reset)
            print(f"danube bf16 ring step seed {seed} x{factor:g}: kernels "
                  f"vs plain {rel:.4g} [limit {cs.RING_BF16_TOL:g}]",
                  flush=True)
        del params, rings
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--faults", type=float, nargs="+",
                    default=[1.005, 1.01, 0.99])
    ap.add_argument("--no-models", action="store_true")
    ap.add_argument("--backward", action="store_true",
                    help="read phase 15's checks, the fault planted in the "
                         "flash backward")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_margins: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.gpu_name_and_power_limit()}", flush=True)
    if args.backward:
        backward_rows(dev, args.seeds, args.faults)
        if not args.no_models:
            train_gates(dev, args.seeds, args.faults)
        return 0
    kernel_rows(dev, args.seeds, args.faults)
    if not args.no_models:
        deepseek_gates(dev, args.seeds, args.faults)
        ring_steps(dev, args.seeds, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
