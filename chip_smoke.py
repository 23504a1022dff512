#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths through the entry points a user calls:

  * main path: ``monte_carlo_policy(..., policy="bfjs", engine="cuda")`` — a
    128-member Monte-Carlo ensemble of the paper's 1000-server cluster under
    the Fig. 4b job-size law U[0.1, 0.9] at offered load 0.85, 1000 slots;
  * best-fit path: ``best_fit_batched`` on 128 clusters of 1000 servers
    with bursts of 4096 jobs.

Each path runs with the kernels' launch counters set to 0 just before it and
read just after.  The second-to-last line of stdout is a JSON object with
one entry per kernel (launches, error against the plain version, kernel,
plain and bound times); the last line is ``{"ok": true, "device": ...}``.
Any failed phase raises, and the script exits non-zero without a result —
also when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet) used for the bounds: HBM
#: bytes per second, and float32 operations per second outside the tensor
#: cores (the kernels' compares and selects).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work in ms, and which of bytes/operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    """Largest absolute difference over the tensor fields of two results."""
    err = 0.0
    for x, y in zip(a, b):
        if x is not None:
            err = max(err, (x.double() - y.double()).abs().max().item())
    return err


def require_equal(what: str, a, b) -> None:
    """Hold every field of a kernel result exactly equal to the plain one."""
    import torch
    for i, (x, y) in enumerate(zip(a, b)):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{what}: field {i} differs from the plain "
                                 f"version (max abs err {max_abs_err(a, b)})")


def bfjs_work(streams, res, L, K, Qcap, A_max) -> tuple[float, float]:
    """Bytes and operations the BF-J/S slot engine needs on these inputs.

    Bytes: the counts, the sizes of the arrivals and one duration per
    placement read once; the three (G, T) trajectories and two counters
    written once.  Operations: per slot, one departure test per server slot
    and one empty test per queue slot; per placement, one pass over the
    residuals and one over the queue.  Placements are counted from this
    run: landed arrivals minus the jobs still queued at the end."""
    G, T = streams.n.shape
    arrivals = int(streams.n.sum())
    landed = arrivals - int(res.dropped.sum())
    placed = landed - int(res.queue_len[:, -1].sum())
    nbytes = 4 * (G * T + arrivals + placed + 3 * G * T + 2 * G)
    ops = G * T * (L * K + Qcap) + placed * (L + Qcap)
    return nbytes, ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.core.engine import (Workload, ensemble_streams,
                                         monte_carlo_policy)
    from repro_torch.kernels import build
    from repro_torch.kernels.best_fit import best_fit as bf_kernel
    from repro_torch.kernels.best_fit.ops import best_fit_batched
    from repro_torch.kernels.best_fit.ref import best_fit_ref_batched
    from repro_torch.kernels.bfjs import bfjs as bfjs_kernel
    from repro_torch.kernels.bfjs.ref import bfjs_ref
    from repro_torch.kernels.common import (GracefulDegradationWarning,
                                            ensemble_plane_bytes)
    warnings.simplefilter("error", GracefulDegradationWarning)

    dev = torch.device("cuda")
    card = gpu_name_and_power_limit()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    def uniform(lo, hi):
        def sampler(gen, n, device):
            return torch.rand(n, generator=gen, device=device) * (hi - lo) \
                + lo
        return sampler

    rows = {}

    # -- 1. best_fit kernel vs plain, at the best-fit path's shapes --------
    G, L, N = 128, 1000, 4096
    rng = np.random.default_rng(args.seed)
    resid = torch.from_numpy(rng.uniform(0, 1, (G, L)).astype(np.float32)
                             ).to(dev)
    sizes = torch.from_numpy(rng.uniform(0.01, 0.3, (G, N)).astype(
        np.float32)).to(dev)
    got = bf_kernel.best_fit_cuda(resid, sizes)
    torch.cuda.synchronize()
    ref = best_fit_ref_batched(resid, sizes)
    require_equal("best_fit", got, ref)
    placed = int((got[0] >= 0).sum())
    bf_ms = time_ms(lambda: bf_kernel.best_fit_cuda(resid, sizes), reps=5)
    bf_plain_ms = time_ms(lambda: best_fit_ref_batched(resid, sizes), reps=1)
    bf_bound, bf_by = bound(4 * 2 * (G * L + G * N), G * N * L)
    print(f"best_fit G={G} L={L} N={N}: equal to plain (exact); "
          f"{placed} of {G * N} placed; kernel {bf_ms:.3f} ms, plain "
          f"{bf_plain_ms:.1f} ms, bound {bf_bound:.4f} ms ({bf_by})")

    # -- 2. bfjs kernel vs plain, bench shape and full width ---------------
    for tag, (Gc, Lc, Kc, Qc, Ac, Tc, lam, mu, lo, hi) in {
            "bench": (8, 16, 24, 512, 8, 2000, 1.5, 0.01, 0.05, 0.5),
            "full-width": (2, 1000, 16, 4096, 48, 200, 17.0, 0.01, 0.1,
                           0.9)}.items():
        st = ensemble_streams(range(args.seed, args.seed + Gc), lam, mu,
                              uniform(lo, hi), L=Lc, K=Kc, A_max=Ac,
                              horizon=Tc, device=dev)
        kw = dict(L=Lc, K=Kc, Qcap=Qc, A_max=Ac, work_steps=Ac + 4)
        got = bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs, **kw)
        torch.cuda.synchronize()
        ref = bfjs_ref(st.n, st.sizes, st.durs, **kw)
        require_equal(f"bfjs {tag}", got, ref)
        print(f"bfjs {tag} G={Gc} L={Lc} K={Kc} Qcap={Qc} A_max={Ac} "
              f"T={Tc}: equal to plain (exact); truncated "
              f"{int(got.truncated.sum())}, dropped {int(got.dropped.sum())}")
        del st, got, ref

    # -- 3. main path at full width -----------------------------------------
    Gm, Lm, Km, Qm, Am, Tm = 128, 1000, 16, 4096, 48, 1000
    mu, size_mean = 0.01, 0.5
    lam = 0.85 * Lm * mu / size_mean           # Fig. 4b rule at alpha=0.85
    wl = Workload(lam=lam, mu=mu, sampler=uniform(0.1, 0.9))
    seeds = range(args.seed, args.seed + Gm)
    cfg = dict(L=Lm, K=Km, Qcap=Qm, A_max=Am, horizon=Tm)
    bfjs_kernel.launches.reset()
    bf_kernel.launches.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = monte_carlo_policy(wl, seeds=seeds, policy="bfjs", engine="cuda",
                             strict=True, device=dev, **cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    planes_gb = ensemble_plane_bytes(Gm, Tm, stream_lanes=1 + 2 * Am + Lm * Km,
                                     out_lanes=3) / 1e9
    bfjs_launches = bfjs_kernel.launches.count
    if bfjs_launches < 1:
        raise AssertionError("main path did not launch the bfjs kernel")
    if bf_kernel.launches.count:
        raise AssertionError("main path launched best_fit unexpectedly")
    qlen, occ, dep = res.queue_len, res.occupancy, res.departed
    if qlen.shape != (Gm, Tm) or not torch.isfinite(occ).all():
        raise AssertionError("main path: bad result shape or values")
    if int(qlen.min()) < 0:
        raise AssertionError("main path: negative queue length")
    if bool((dep[:, 1:] < dep[:, :-1]).any()):
        raise AssertionError("main path: departures not monotone")
    if float(occ.min()) < 0 or float(occ.max()) > Lm:
        raise AssertionError("main path: occupancy outside [0, L]")
    offered = lam * size_mean / (mu * Lm)
    util = float(occ[:, 500:].double().mean()) / Lm
    if abs(util - offered) > 0.03:
        raise AssertionError(f"main path: utilisation {util:.4f} not within "
                             f"0.03 of the offered load {offered:.4f}")
    print(f"main path bfjs G={Gm} L={Lm} K={Km} Qcap={Qm} A_max={Am} "
          f"T={Tm} lam={lam}: wall {wall_ms:.1f} ms (streams + kernel), "
          f"{Gm * Tm / wall_ms * 1e3:.0f} ensemble-slots/s; utilisation "
          f"{util:.4f} vs offered {offered:.4f}; mean queue "
          f"{float(qlen.double().mean()):.2f}; dropped "
          f"{int(res.dropped.sum())}; truncated {int(res.truncated.sum())}; "
          f"bfjs launches {bfjs_launches}; device memory peak "
          f"{peak_gb:.2f} GB (streams + trajectories {planes_gb:.2f} GB)")

    # the main path's kernel call again, against the plain version on the
    # same streams (launches here are for comparison and are not counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ensemble_streams(seeds, lam, mu, uniform(0.1, 0.9), L=Lm, K=Km,
                          A_max=Am, horizon=Tm, device=dev)
    torch.cuda.synchronize()
    streams_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(L=Lm, K=Km, Qcap=Qm, A_max=Am, work_steps=Am + 4)
    got = bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs, **kw)
    require_equal("bfjs main path vs monte_carlo_policy", got, res)
    bfjs_ms = time_ms(lambda: bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs,
                                                    **kw), reps=3)
    t0 = time.perf_counter()
    ref = bfjs_ref(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    bfjs_plain_ms = (time.perf_counter() - t0) * 1e3
    require_equal("bfjs main path", got, ref)
    bfjs_bound, bfjs_by = bound(*bfjs_work(st, got, Lm, Km, Qm, Am))
    print(f"bfjs main-path shapes: equal to plain (exact); streams "
          f"{streams_ms:.1f} ms, kernel {bfjs_ms:.1f} ms, plain "
          f"{bfjs_plain_ms:.1f} ms, bound {bfjs_bound:.4f} ms ({bfjs_by})")
    rows["bfjs"] = dict(
        name="bfjs", route="cuda",
        source="src/repro_torch/kernels/csrc/bfjs.cu",
        replaces="src/repro/kernels/bfjs/bfjs.py:37",
        launches=bfjs_launches, max_abs_err=max_abs_err(got, ref),
        ms=bfjs_ms, plain_ms=bfjs_plain_ms, bound_ms=bfjs_bound,
        bound_by=bfjs_by, library_ms=None)
    del st, got, ref, res

    # -- 4. best-fit path ----------------------------------------------------
    bf_kernel.launches.reset()
    bfjs_kernel.launches.reset()
    assign, new_resid = best_fit_batched(resid, sizes)
    torch.cuda.synchronize()
    bf_launches = bf_kernel.launches.count
    if bf_launches < 1 or bfjs_kernel.launches.count:
        raise AssertionError("best-fit path did not launch best_fit alone")
    if int(assign.min()) < -1 or int(assign.max()) >= L \
            or float(new_resid.min()) < 0:
        raise AssertionError("best-fit path: assignment or residual "
                             "out of range")
    ref_bf = best_fit_ref_batched(resid, sizes)
    require_equal("best-fit path", (assign, new_resid), ref_bf)
    print(f"best-fit path: {int((assign >= 0).sum())} of {G * N} jobs "
          f"placed; best_fit launches {bf_launches}")
    rows["best_fit"] = dict(
        name="best_fit", route="cuda",
        source="src/repro_torch/kernels/csrc/best_fit.cu",
        replaces="src/repro/kernels/best_fit/best_fit.py:27",
        launches=bf_launches,
        max_abs_err=max_abs_err((assign, new_resid), ref_bf),
        ms=bf_ms, plain_ms=bf_plain_ms, bound_ms=bf_bound, bound_by=bf_by,
        library_ms=None)

    print(json.dumps({"kernels": [rows["bfjs"], rows["best_fit"]],
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
