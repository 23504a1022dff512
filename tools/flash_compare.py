#!/usr/bin/env python3
"""Time the flash-attention kernels of this checkout against those of
another checkout (its parent commit, say) on one card, in one run.

    python3 tools/flash_compare.py [--parent DIR] [--reps 20] [--ptxas]

Each measurement runs in a process of its own that imports ``repro_torch``
(and ``chip_smoke``'s shape tables) from the checkout it measures, in the
order parent, this checkout, this checkout, parent, so a drift of the
card's clock shows as a difference between the two runs of one tree.
Without ``--parent`` this checkout runs twice.  Every process prints:

* the forward kernel's device time (a CUDA graph of ``--reps`` calls of
  its ``_forward``) at ``FWD_SHAPES``, on the model's (B, S, H, hd)
  views;
* the backward kernel's device time at each ``BWD_SHAPES`` shape and
  dtype of its ``chip_smoke.py``, fed the forward kernel's log-sum-exp
  where its ``flash_attention_bwd_cuda`` takes one;

and with ``--ptxas``, once a checkout, the assembler's registers and spills
of each kernel function of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``.  The last line is one JSON object: each
tree's runs.  It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: Forward shapes (B, H, KV, S, hd, hd_v, window, dtype): llama3-8b's
#: 2048-token prefill (the serve path's), its training microbatch in bf16
#: and float32, danube's window and MLA's widths.
FWD_SHAPES = {
    "prefill": (1, 32, 8, 2048, 128, 128, 0, "bfloat16"),
    "llama": (2, 32, 8, 2048, 128, 128, 0, "bfloat16"),
    "llama_float32": (2, 32, 8, 2048, 128, 128, 0, "float32"),
    "swa": (1, 32, 8, 8192, 120, 120, 4096, "bfloat16"),
    "mla": (1, 16, 16, 2048, 192, 128, 0, "bfloat16")}

SOURCES = ("flash_attention", "flash_attention_bwd")


def ptxas(tree: Path) -> dict[str, list[str]]:
    """``ptxas -v`` lines of the two flash sources of ``tree``."""
    from repro_torch.kernels import build
    out = {}
    for name in SOURCES:
        src = tree / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        with tempfile.TemporaryDirectory() as tmp:
            log = subprocess.run(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(Path(tmp) / f"{name}.so"), str(src)],
                capture_output=True, text=True, check=True)
        keep = ("Compiling entry function", "registers", "spill")
        out[name] = [line.strip() for line in (log.stdout + log.stderr)
                     .splitlines() if any(k in line for k in keep)]
    return out


def measure(tree: Path, reps: int, with_ptxas: bool) -> dict:
    """One process's readings on ``tree``'s kernels."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs        # puts tree/src on sys.path
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    bwd_lse = "lse" in inspect.signature(fa.flash_attention_bwd_cuda
                                         ).parameters
    row: dict = {"tree": str(tree), "fwd": {}, "bwd": {}}
    for tag, (B, H, KV, S, hd, hd_v, w, dt) in FWD_SHAPES.items():
        dtype = getattr(torch, dt)
        rng = np.random.default_rng([0, list(FWD_SHAPES).index(tag)])
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, d)).astype(
            np.float32)).to(device=dev, dtype=dtype).transpose(1, 2)
            for n, d in ((H, hd), (KV, hd), (KV, hd_v)))
        row["fwd"][tag] = cs.device_ms(
            lambda: fa._forward(q, k, v, True, w), reps)
        torch.cuda.empty_cache()
    for tag, shape in cs.BWD_SHAPES.items():
        for dt in shape[-1]:
            q, k, v, out, dout = cs.bwd_inputs(dev, 0, tag, getattr(torch, dt))
            w = shape[6]
            extra = (fa._forward(q, k, v, True, w)[1],) if bwd_lse else ()
            n = 3 if dt == "float32" or tag == "swa" else reps
            row["bwd"][f"{tag}_{dt}"] = cs.device_ms(
                lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, out, dout, *extra, causal=True, window=w), n)
            del q, k, v, out, dout, extra
            torch.cuda.empty_cache()
    if with_ptxas:
        row["ptxas"] = ptxas(tree)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(measure(args.one, args.reps, args.ptxas)),
              flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_compare: no CUDA device")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    parent = args.parent.resolve() if args.parent else ROOT
    runs: dict[str, list] = {"parent": [], "change": []}
    seen = set()
    for which in ("parent", "change", "change", "parent"):
        tree = parent if which == "parent" else ROOT
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(tree), "--reps", str(args.reps)]
        if args.ptxas and which not in seen:
            cmd.append("--ptxas")
        seen.add(which)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            sys.exit(f"flash_compare: the {which} run failed "
                     f"(rc {res.returncode})")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        for kind in ("fwd", "bwd"):
            for tag, ms in row[kind].items():
                print(f"{which} {kind} {tag}: {ms}", flush=True)
        for name, lines in row.get("ptxas", {}).items():
            print(f"{which} ptxas {name}:\n  " + "\n  ".join(lines),
                  flush=True)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
