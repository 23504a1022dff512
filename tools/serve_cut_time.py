#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 9 (the llama3-8b serve path with phase
13e's serve on its weights) of two checkouts on one card, in turns.

    python3 tools/serve_cut_time.py --parent DIR [--order parent change]
        [--seed 0]

``DIR`` is another checkout of the repository (unpack one with ``git
archive REV | tar -x -C .chip_archive/parent``; ``.gitignore`` lists that
directory).  Each run is a process of its own that builds its checkout's
kernels, then runs that checkout's ``serve_path`` exactly as its
``chip_smoke.py`` does, and prints the phase's host seconds (the build
excluded) and the card's name and power limit.

It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention as da
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.live_admission import live_admission as lk
build.build_all()
counters = {"decode_attention": da.launches, "flash_attention": fa.launches,
            "live_admission": lk.launches}
def reset():
    for c in counters.values():
        c.reset()
dev, seed = torch.device("cuda"), int(sys.argv[2])
t0 = time.perf_counter()
cs.serve_path(dev, seed, counters, reset, with_weights=lambda cfg, p:
              cs.live_serve(cfg, p, dev, seed, counters, reset))
print(f"serve_cut_time: {sys.argv[3]} phase 9 "
      f"{time.perf_counter() - t0:.1f} s on {cs.gpu_name_and_power_limit()}",
      flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--order", nargs="+", default=["parent", "change"],
                    choices=["parent", "change"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_cut_time: no CUDA device is available", file=sys.stderr)
        return 1
    roots = {"parent": args.parent.resolve(), "change": ROOT}
    for tag in args.order:
        root = roots[tag]
        run = subprocess.run([sys.executable, "-c", CHILD, str(root),
                              str(args.seed), tag], cwd=root)
        if run.returncode != 0:
            print(f"serve_cut_time: the {tag} run failed "
                  f"(exit {run.returncode})", file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
