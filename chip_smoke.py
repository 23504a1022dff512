#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths through the entry points a user calls:

  * bfjs path: ``monte_carlo_policy(..., policy="bfjs", engine="cuda")`` —
    a 128-member Monte-Carlo ensemble of the paper's 1000-server cluster
    under the Fig. 4b job-size law U[0.1, 0.9] at offered load 0.85, 1000
    slots;
  * vqs and vqs-bf paths: the same cluster and law with that panel's
    J = 4, K = 16, Qcap = 1024, at offered load 0.6 (inside the proven
    2/3 region of both policies), 128 members, 1000 slots;
  * bfjs-mr path: ``monte_carlo_policy(..., policy="bfjs-mr",
    engine="cuda")`` — the same cluster with two resources (cpu, mem),
    each demand U[0.1, 0.9] independently, at offered load 0.8 per
    resource, Qcap = 1024, 128 members, 1000 slots;
  * best-fit path: ``best_fit_batched`` on 128 clusters of 1000 servers
    with bursts of 4096 jobs.

Each path runs with every kernel's launch counter set to 0 just before it
and read just after; it must launch its own kernel and no other.  The
second-to-last line of stdout is a JSON object with one entry per kernel
(launches, error against the plain version, kernel, plain and bound
times); the last line is ``{"ok": true, "device": ...}``.  Any failed phase
raises, and the script exits non-zero without a result — also when no
CUDA device is present.
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

#: Members of the full-width streams the VQS-family kernels are held
#: against their plain versions on (members are independent, so the first
#: eight of the ensemble are an exact sub-problem).
PLAIN_MEMBERS = 8


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


def wall_ms(fn) -> tuple[float, object]:
    """Host-clock milliseconds of one synchronised call, and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


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


def members(res, g: int):
    """The first ``g`` members of a batched result."""
    return type(res)(*(x[:g] if x is not None else None for x in res))


def placements(streams, res) -> tuple[int, int]:
    """(arrivals, placements) of a run: placements are the landed arrivals
    minus the jobs still queued at the end."""
    arrivals = int(streams.n.sum())
    landed = arrivals - int(res.dropped.sum())
    return arrivals, landed - int(res.queue_len[:, -1].sum())


def bfjs_work(streams, res, L, K, Qcap, A_max) -> tuple[float, float]:
    """Bytes and operations the BF-J/S slot engine needs on these inputs.

    Bytes: the counts, the sizes of the arrivals and one duration per
    placement read once; the three (G, T) trajectories and two counters
    written once.  Operations: per slot, one departure test per server slot
    and one empty test per queue slot; per placement, one pass over the
    residuals and one over the queue.  Placements are counted from this
    run: landed arrivals minus the jobs still queued at the end."""
    G, T = streams.n.shape
    arrivals, placed = placements(streams, res)
    nbytes = 4 * (G * T + arrivals + placed + 3 * G * T + 2 * G)
    ops = G * T * (L * K + Qcap) + placed * (L + Qcap)
    return nbytes, ops


def vqs_work(streams, res, L, J, scan_queue: bool) -> tuple[float, float]:
    """Bytes and operations a VQS-family slot engine needs on these inputs.

    Bytes: the counts, and the size and duration of each arrival read once;
    the three (G, T) trajectories and two counters written once.
    Operations: per slot, one departure/visit test per server; per arrival,
    its 2J-way classification; per placement, one pass over the servers to
    find the placer.  VQS-BF's largest-fit pops also pass over the queued
    jobs once a slot (``scan_queue``: the sum of this run's queue
    lengths)."""
    G, T = streams.n.shape
    arrivals, placed = placements(streams, res)
    nbytes = 4 * (G * T + 2 * arrivals + 3 * G * T + 2 * G)
    ops = G * T * L + arrivals * 2 * J + placed * L
    if scan_queue:
        ops += int(res.queue_len.sum())
    return nbytes, ops


def mr_work(streams, res, L) -> tuple[float, float]:
    """Bytes and operations the multi-resource BF-J/S slot engine needs on
    these inputs.

    Bytes: the counts, and each arrival's R demands and duration read
    once; the (G, T) queue and departure trajectories, the (G, T, R)
    occupancy and two counters written once.  Operations: per slot, one
    departure test per server; per arrival, one R-resource feasibility and
    score pass over the servers (BF-J); per slot, one R-resource fit test
    of every queued job for each server that a departure freed (BF-S).
    Departures and queue lengths are this run's."""
    import torch
    G, T, A, R = streams.sizes.shape
    arrivals = int(streams.n.sum())
    ndep = torch.diff(res.departed, dim=1,
                      prepend=torch.zeros_like(res.departed[:, :1]))
    nbytes = 4 * (G * T + arrivals * (R + 1) + (2 + R) * G * T + 2 * G)
    ops = G * T * L + arrivals * L * R \
        + float((ndep.double() * res.queue_len.double()).sum()) * R
    return nbytes, ops


def check_path(tag: str, res, G, T, L, offered, counters, own):
    """The invariants every Monte-Carlo path must keep; returns the
    utilisation over slots 500..T-1 (a tuple, one per resource, where the
    occupancy has a resource axis)."""
    import torch
    for name, counter in counters.items():
        if name == own and counter.count < 1:
            raise AssertionError(f"{tag}: did not launch the {own} kernel")
        if name != own and counter.count:
            raise AssertionError(f"{tag}: launched {name} unexpectedly")
    qlen, occ, dep = res.queue_len, res.occupancy, res.departed
    if qlen.shape != (G, T) or not torch.isfinite(occ).all():
        raise AssertionError(f"{tag}: bad result shape or values")
    if int(qlen.min()) < 0:
        raise AssertionError(f"{tag}: negative queue length")
    if bool((dep[:, 1:] < dep[:, :-1]).any()):
        raise AssertionError(f"{tag}: departures not monotone")
    if float(occ.min()) < 0 or float(occ.max()) > L:
        raise AssertionError(f"{tag}: occupancy outside [0, L]")
    per = occ[:, 500:].double().mean((0, 1)) / L
    utils = tuple(float(u) for u in per.reshape(-1))
    for util in utils:
        if abs(util - offered) > 0.03:
            raise AssertionError(f"{tag}: utilisation {util:.4f} not "
                                 f"within 0.03 of the offered load "
                                 f"{offered:.4f}")
    return utils if occ.ndim == 3 else utils[0]


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
    from repro_torch.kernels.bfjs_mr import bfjs_mr as bfjs_mr_kernel
    from repro_torch.kernels.bfjs_mr.ref import bfjs_mr_ref
    from repro_torch.kernels.common import (GracefulDegradationWarning,
                                            ensemble_plane_bytes)
    from repro_torch.kernels.vqs import vqs as vqs_kernel
    from repro_torch.kernels.vqs.ref import vqs_ref
    from repro_torch.kernels.vqs_bf import vqs_bf as vqs_bf_kernel
    from repro_torch.kernels.vqs_bf.ref import vqs_bf_ref
    warnings.simplefilter("error", GracefulDegradationWarning)
    counters = {"best_fit": bf_kernel.launches,
                "bfjs": bfjs_kernel.launches,
                "bfjs_mr": bfjs_mr_kernel.launches,
                "vqs": vqs_kernel.launches,
                "vqs_bf": vqs_bf_kernel.launches}

    def reset_counters():
        for c in counters.values():
            c.reset()

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_name_and_power_limit()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    def uniform(lo, hi, R=1):
        def sampler(gen, n, device):
            shape = (n,) if R == 1 else (n, R)
            return torch.rand(shape, generator=gen, device=device) \
                * (hi - lo) + lo
        return sampler

    def anti_correlated(gen, n, device):
        """(cpu, mem) demands: one resource U(0.45, 0.55), the other
        U(0.05, 0.1), each half the time (benchmarks/sched_micro.py
        ``_mr_sampler``)."""
        heavy = torch.rand(n, generator=gen, device=device) * 0.1 + 0.45
        light = torch.rand(n, generator=gen, device=device) * 0.05 + 0.05
        flip = torch.rand(n, generator=gen, device=device) < 0.5
        return torch.stack([torch.where(flip, heavy, light),
                            torch.where(flip, light, heavy)], dim=1)

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

    # -- 3. vqs and vqs_bf kernels vs plain at the bench shape -------------
    # (benchmarks/sched_micro.py's VQS ensemble config; Qcap = 8192 puts
    # the rings in the global workspace)
    Gb, Lb, Kb, Qb, Ab, Tb, Jb = 8, 16, 24, 8192, 8, 2000, 4
    st = ensemble_streams(range(args.seed, args.seed + Gb), 1.5, 0.01,
                          uniform(0.05, 0.5), L=Lb, K=Kb, A_max=Ab,
                          horizon=Tb, device=dev)
    for name, fn, plain, extra in (
            ("vqs", vqs_kernel.vqs_cuda, vqs_ref,
             dict(work_steps=Ab + 4, drain=16)),
            ("vqs_bf", vqs_bf_kernel.vqs_bf_cuda, vqs_bf_ref,
             dict(work_steps=64))):
        kw = dict(J=Jb, L=Lb, K=Kb, Qcap=Qb, A_max=Ab, **extra)
        got = fn(st.n, st.sizes, st.durs, **kw)
        torch.cuda.synchronize()
        require_equal(f"{name} bench", got,
                      plain(st.n, st.sizes, st.durs, **kw))
        print(f"{name} bench G={Gb} J={Jb} L={Lb} K={Kb} Qcap={Qb} "
              f"A_max={Ab} T={Tb}: equal to plain (exact); truncated "
              f"{int(got.truncated.sum())}, dropped {int(got.dropped.sum())}")
    del st, got

    # -- 3b. bfjs_mr kernel vs plain at the bench shape ---------------------
    # (benchmarks/sched_micro.py's _bench_mr_engines config on 4 members:
    # the anti-correlated law, where alignment packing differs most from
    # the max-collapse)
    Gb, Lb, Kb, Qb, Ab, Tb = 4, 16, 16, 512, 8, 3000
    st = ensemble_streams(range(args.seed, args.seed + Gb), 1.2, 0.05,
                          anti_correlated, L=Lb, K=Kb, A_max=Ab, horizon=Tb,
                          device=dev, num_resources=2)
    kw = dict(L=Lb, K=Kb, Qcap=Qb, A_max=Ab, work_steps=24,
              capacity=(1.0, 1.0))
    got = bfjs_mr_kernel.bfjs_mr_cuda(st.n, st.sizes, st.durs, **kw)
    torch.cuda.synchronize()
    require_equal("bfjs_mr bench", got, bfjs_mr_ref(st.n, st.sizes,
                                                     st.durs, **kw))
    print(f"bfjs_mr bench G={Gb} R=2 L={Lb} K={Kb} Qcap={Qb} A_max={Ab} "
          f"T={Tb}: equal to plain (exact); mean queue "
          f"{float(got.queue_len.double().mean()):.2f}, truncated "
          f"{int(got.truncated.sum())}, dropped {int(got.dropped.sum())}")
    del st, got

    # -- 4. bfjs path at full width -------------------------------------------
    Gm, Lm, Km, Qm, Am, Tm = 128, 1000, 16, 4096, 48, 1000
    mu, size_mean = 0.01, 0.5
    lam = 0.85 * Lm * mu / size_mean           # Fig. 4b rule at alpha=0.85
    wl = Workload(lam=lam, mu=mu, sampler=uniform(0.1, 0.9))
    seeds = range(args.seed, args.seed + Gm)
    cfg = dict(L=Lm, K=Km, Qcap=Qm, A_max=Am, horizon=Tm)
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    wall, res = wall_ms(lambda: monte_carlo_policy(
        wl, seeds=seeds, policy="bfjs", engine="cuda", strict=True,
        device=dev, **cfg))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    planes_gb = ensemble_plane_bytes(Gm, Tm, stream_lanes=1 + 2 * Am + Lm * Km,
                                     out_lanes=3) / 1e9
    bfjs_launches = bfjs_kernel.launches.count
    offered = lam * size_mean / (mu * Lm)
    util = check_path("bfjs path", res, Gm, Tm, Lm, offered, counters,
                      "bfjs")
    qlen = res.queue_len
    print(f"bfjs path G={Gm} L={Lm} K={Km} Qcap={Qm} A_max={Am} "
          f"T={Tm} lam={lam}: wall {wall:.1f} ms (streams + kernel), "
          f"{Gm * Tm / wall * 1e3:.0f} ensemble-slots/s; utilisation "
          f"{util:.4f} vs offered {offered:.4f}; mean queue "
          f"{float(qlen.double().mean()):.2f}; dropped "
          f"{int(res.dropped.sum())}; truncated {int(res.truncated.sum())}; "
          f"bfjs launches {bfjs_launches}; device memory peak "
          f"{peak_gb:.2f} GB (streams + trajectories {planes_gb:.2f} GB)")

    # the path's kernel call again, against the plain version on the same
    # streams (launches here are for comparison and are not counted)
    streams_ms, st = wall_ms(lambda: ensemble_streams(
        seeds, lam, mu, uniform(0.1, 0.9), L=Lm, K=Km, A_max=Am,
        horizon=Tm, device=dev))
    kw = dict(L=Lm, K=Km, Qcap=Qm, A_max=Am, work_steps=Am + 4)
    got = bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs, **kw)
    require_equal("bfjs path vs monte_carlo_policy", got, res)
    bfjs_ms = time_ms(lambda: bfjs_kernel.bfjs_cuda(st.n, st.sizes, st.durs,
                                                    **kw), reps=3)
    bfjs_plain_ms, ref = wall_ms(lambda: bfjs_ref(st.n, st.sizes, st.durs,
                                                  **kw))
    require_equal("bfjs path", got, ref)
    bfjs_bound, bfjs_by = bound(*bfjs_work(st, got, Lm, Km, Qm, Am))
    print(f"bfjs path shapes: equal to plain (exact); streams "
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

    # -- 5. vqs and vqs-bf paths at full width --------------------------------
    Jv, Qv = 4, 1024
    lam_v = 0.6 * Lm * mu / size_mean          # offered load 0.6: lam = 12
    wl_v = Workload(lam=lam_v, mu=mu, sampler=uniform(0.1, 0.9))
    cfg_v = dict(J=Jv, L=Lm, K=Km, Qcap=Qv, A_max=Am, horizon=Tm)
    for policy, name, fn, plain, source, replaces in (
            ("vqs", "vqs", vqs_kernel.vqs_cuda, vqs_ref,
             "src/repro_torch/kernels/csrc/vqs.cu",
             "src/repro/kernels/vqs/vqs.py:42"),
            ("vqs-bf", "vqs_bf", vqs_bf_kernel.vqs_bf_cuda, vqs_bf_ref,
             "src/repro_torch/kernels/csrc/vqs_bf.cu",
             "src/repro/kernels/vqs_bf/vqs_bf.py:45")):
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        wall, res = wall_ms(lambda: monte_carlo_policy(
            wl_v, seeds=seeds, policy=policy, engine="cuda", strict=True,
            device=dev, **cfg_v))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = counters[name].count
        offered = lam_v * size_mean / (mu * Lm)
        util = check_path(f"{policy} path", res, Gm, Tm, Lm, offered,
                          counters, name)
        if int(res.dropped.sum()):
            raise AssertionError(f"{policy} path: {int(res.dropped.sum())} "
                                 "arrivals dropped")
        print(f"{policy} path G={Gm} J={Jv} L={Lm} K={Km} Qcap={Qv} "
              f"A_max={Am} T={Tm} lam={lam_v}: wall {wall:.1f} ms (streams "
              f"+ kernel), {Gm * Tm / wall * 1e3:.0f} ensemble-slots/s; "
              f"utilisation {util:.4f} vs offered {offered:.4f}; mean queue "
              f"{float(res.queue_len.double().mean()):.2f}; dropped 0; "
              f"truncated {int(res.truncated.sum())}; {name} launches "
              f"{launches}; device memory peak {peak_gb:.2f} GB")

        streams_ms, st = wall_ms(lambda: ensemble_streams(
            seeds, lam_v, mu, uniform(0.1, 0.9), L=Lm, K=Km, A_max=Am,
            horizon=Tm, device=dev))
        kw = dict(J=Jv, L=Lm, K=Km, Qcap=Qv, A_max=Am, work_steps=Am + 4)
        if name == "vqs":
            kw["drain"] = 16
        got = fn(st.n, st.sizes, st.durs, **kw)
        require_equal(f"{policy} path vs monte_carlo_policy", got, res)
        ms = time_ms(lambda: fn(st.n, st.sizes, st.durs, **kw), reps=3)
        g = PLAIN_MEMBERS
        sub = (st.n[:g], st.sizes[:g], st.durs[:g])
        plain_ms, ref = wall_ms(lambda: plain(*sub, **kw))
        require_equal(f"{policy} path, first {g} members", members(got, g),
                      ref)
        sub_ms = time_ms(lambda: fn(*sub, **kw), reps=3)
        b_ms, b_by = bound(*vqs_work(st, got, Lm, Jv, name == "vqs_bf"))
        shape = (Jv, Lm, Km, Qv, Am)
        ws = getattr(vqs_kernel.load(name), f"{name}_workspace_bytes")
        print(f"{policy} path shapes: equal to plain on members 0..{g - 1} "
              f"(exact); streams {streams_ms:.1f} ms, kernel {ms:.1f} ms "
              f"({Gm} members) / {sub_ms:.1f} ms ({g} members), plain "
              f"{plain_ms:.1f} ms ({g} members), bound {b_ms:.4f} ms "
              f"({b_by}); shared memory "
              f"{vqs_kernel.shared_bytes(name, *shape)} B a block, "
              f"workspace {ws(*shape)} B a member")
        rows[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max_abs_err(members(got, g), ref), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, plain_members=g)
        del st, got, ref, res, sub

    # -- 6. bfjs-mr path at full width ----------------------------------------
    Rm, Qr = 2, 1024
    lam_r = 0.8 * Lm * mu / size_mean          # offered load 0.8: lam = 16
    wl_r = Workload(lam=lam_r, mu=mu, sampler=uniform(0.1, 0.9, Rm),
                    num_resources=Rm)
    cfg_r = dict(L=Lm, K=Km, Qcap=Qr, A_max=Am, horizon=Tm)
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    wall, res = wall_ms(lambda: monte_carlo_policy(
        wl_r, seeds=seeds, policy="bfjs-mr", engine="cuda", strict=True,
        device=dev, **cfg_r))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mr_launches = bfjs_mr_kernel.launches.count
    offered = lam_r * size_mean / (mu * Lm)
    utils = check_path("bfjs-mr path", res, Gm, Tm, Lm, offered, counters,
                       "bfjs_mr")
    mean_q = float(res.queue_len.double().mean())
    if int(res.dropped.sum()):
        raise AssertionError(f"bfjs-mr path: {int(res.dropped.sum())} "
                             "arrivals dropped")
    if not mean_q > 0:
        raise AssertionError("bfjs-mr path: the queue never filled, so no "
                             "BF-S refill was timed")
    print(f"bfjs-mr path G={Gm} R={Rm} L={Lm} K={Km} Qcap={Qr} A_max={Am} "
          f"T={Tm} lam={lam_r}: wall {wall:.1f} ms (streams + kernel), "
          f"{Gm * Tm / wall * 1e3:.0f} ensemble-slots/s; utilisation "
          f"{', '.join(f'{u:.4f}' for u in utils)} (cpu, mem) vs offered "
          f"{offered:.4f}; mean queue {mean_q:.2f}; dropped 0; truncated "
          f"{int(res.truncated.sum())}; bfjs_mr launches {mr_launches}; "
          f"device memory peak {peak_gb:.2f} GB")

    streams_ms, st = wall_ms(lambda: ensemble_streams(
        seeds, lam_r, mu, uniform(0.1, 0.9, Rm), L=Lm, K=Km, A_max=Am,
        horizon=Tm, device=dev, num_resources=Rm))
    kw = dict(L=Lm, K=Km, Qcap=Qr, A_max=Am, work_steps=Am + 4,
              capacity=(1.0,) * Rm)
    got = bfjs_mr_kernel.bfjs_mr_cuda(st.n, st.sizes, st.durs, **kw)
    require_equal("bfjs-mr path vs monte_carlo_policy", got, res)
    ms = time_ms(lambda: bfjs_mr_kernel.bfjs_mr_cuda(st.n, st.sizes,
                                                     st.durs, **kw), reps=3)
    g = PLAIN_MEMBERS
    sub = (st.n[:g], st.sizes[:g], st.durs[:g])
    plain_ms, ref = wall_ms(lambda: bfjs_mr_ref(*sub, **kw))
    require_equal(f"bfjs-mr path, first {g} members", members(got, g), ref)
    sub_ms = time_ms(lambda: bfjs_mr_kernel.bfjs_mr_cuda(*sub, **kw),
                     reps=3)
    b_ms, b_by = bound(*mr_work(st, got, Lm))
    shape = (Lm, Km, Qr, Am, Rm)
    lib = bfjs_mr_kernel.load()
    print(f"bfjs-mr path shapes: equal to plain on members 0..{g - 1} "
          f"(exact, truncated {int(ref.truncated.sum())} in both); streams "
          f"{streams_ms:.1f} ms, kernel {ms:.1f} ms ({Gm} members) / "
          f"{sub_ms:.1f} ms ({g} members), plain {plain_ms:.1f} ms ({g} "
          f"members), bound {b_ms:.4f} ms ({b_by}); shared memory "
          f"{lib.bfjs_mr_shared_bytes(*shape)} B a block, workspace "
          f"{lib.bfjs_mr_workspace_bytes(*shape)} B a member")
    rows["bfjs_mr"] = dict(
        name="bfjs_mr", route="cuda",
        source="src/repro_torch/kernels/csrc/bfjs_mr.cu",
        replaces="src/repro/kernels/bfjs_mr/bfjs_mr.py:46",
        launches=mr_launches, max_abs_err=max_abs_err(members(got, g), ref),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, plain_members=g)
    del st, got, ref, res, sub

    # -- 7. best-fit path ----------------------------------------------------
    reset_counters()
    assign, new_resid = best_fit_batched(resid, sizes)
    torch.cuda.synchronize()
    bf_launches = bf_kernel.launches.count
    if bf_launches < 1 or any(c.count for n, c in counters.items()
                              if n != "best_fit"):
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

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in ("bfjs", "vqs", "vqs_bf",
                                                    "bfjs_mr", "best_fit")],
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
