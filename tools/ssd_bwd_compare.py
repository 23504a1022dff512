#!/usr/bin/env python3
"""Time the chunk scan's backward kernels of this checkout against those
of another checkout (its parent commit, say) on one card, in one run.

    python3 tools/ssd_bwd_compare.py [--parent DIR] [--ptxas]

Each measurement runs in a process of its own that imports ``repro_torch``
(and ``chip_smoke``'s shape tables and stage checks) from the checkout it
measures, in the order parent, this checkout, this checkout, parent, so a
drift of the card's clock shows as a difference between the two runs of
one tree.  Without ``--parent`` this checkout runs twice.  Every process
prints, at each shape of its ``chip_smoke.SSD_BWD_SHAPES`` (chip_smoke's
16a inputs on seed 0, the forward run through the kernels):

* the backward call's time (``ssd_scan_bwd_cuda``, CUDA events, mean of
  10 calls after a warm-up);
* each launch's time from its ``chip_smoke.ssd_bwd_stages``, which first
  holds each launch to its plain stage;

and with ``--ptxas``, once a checkout, the assembler's registers and spills
of each kernel function of ``csrc/ssd_scan_bwd.cu``.  The last line is one
JSON object: each tree's runs.  It needs a CUDA device and exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ptxas(tree: Path) -> list[str]:
    """``ptxas -v`` lines of ``tree``'s ``csrc/ssd_scan_bwd.cu``."""
    from repro_torch.kernels import build
    src = tree / "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
    with tempfile.TemporaryDirectory() as tmp:
        log = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "ssd_scan_bwd.so"), str(src)],
            capture_output=True, text=True, check=True)
    keep = ("Compiling entry function", "registers", "spill")
    return [line.strip() for line in (log.stdout + log.stderr).splitlines()
            if any(k in line for k in keep)]


def measure(tree: Path, with_ptxas: bool) -> dict:
    """One process's readings on ``tree``'s kernels."""
    sys.path.insert(0, str(tree))
    import chip_smoke as cs        # puts tree/src on sys.path
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    assert Path(sk.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all(["ssd_scan", "ssd_scan_bwd"])
    dev = torch.device("cuda")
    row: dict = {"tree": str(tree), "call": {}, "stages": {}}
    for tag in cs.SSD_BWD_SHAPES:
        leaves, views = cs.ssd_bwd_inputs(dev, 0, tag)
        x, b, c, a, g = views(*leaves)
        with torch.no_grad():
            _, saved = sk._scan(x, b, c, a)
        xp, bp, cp, ap, st, tot, out = saved
        gp = sk.operand(g.float(), xp.shape[-1])
        row["call"][tag] = cs.time_ms(lambda: sk.ssd_scan_bwd_cuda(
            xp, bp, cp, ap, gp, out, st, tot), 10)
        row["stages"][tag] = cs.ssd_bwd_stages(tag, xp, bp, cp, ap, gp, out,
                                               st, tot)
        del leaves, x, b, c, a, g, saved, xp, bp, cp, ap, st, tot, out, gp
        torch.cuda.empty_cache()
    if with_ptxas:
        row["ptxas"] = ptxas(tree)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of the checkout to compare with")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(measure(args.one, args.ptxas)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_compare: no CUDA device")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    parent = args.parent.resolve() if args.parent else ROOT
    runs: dict[str, list] = {"parent": [], "change": []}
    seen = set()
    for which in ("parent", "change", "change", "parent"):
        tree = parent if which == "parent" else ROOT
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(tree)]
        if args.ptxas and which not in seen:
            cmd.append("--ptxas")
        seen.add(which)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            sys.exit(f"ssd_bwd_compare: the {which} run failed "
                     f"(rc {res.returncode})")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        for tag, ms in row["call"].items():
            print(f"{which} call {tag}: {ms}", flush=True)
        for tag, stages in row["stages"].items():
            print(f"{which} launches {tag}: " + ", ".join(
                f"{k} {v}" for k, v in stages.items()), flush=True)
        if "ptxas" in row:
            print(f"{which} ptxas ssd_scan_bwd:\n  "
                  + "\n  ".join(row["ptxas"]), flush=True)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
