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
    2/3 region of both policies), 128 members, 1000 slots; then the vqs_bf
    and vqs kernels at offered load 0.8, where their queues fill and the
    ring pops and packing bursts are timed (``ms_at_load_0_8`` in the
    kernels line);
  * the oracle bridge: one trace at the same width (Poisson(16) arrivals a
    slot, load 0.8, sizes U[0.1, 0.9] in float64, durations Geometric(0.01),
    1000 slots, from ``--seed``) replayed through
    ``run_policy_streams(streams_from_trace(...), policy="vqs"|"vqs-bf",
    engine="cuda")``, J = 4, K = 16, Qcap = 4096: each queue trajectory must
    equal the port's event-driven ``simulate_trace`` (host numpy) slot for
    slot, with the departures, nothing truncated or dropped, and one launch
    of the path's own kernel;
  * the trace path: the paper's Google-trace experiment (Section VII.B,
    Fig. 5) at ``benchmarks/fig5.py``'s full-scale statistics and cluster
    (L = 640, mean duration 6000, traffic scaling 1.0), tasks and horizon
    cut 10x to 100,000 over 130,000 slots: the port's
    ``synthesize_google_like_trace`` from ``--seed``, collapsed through the
    ``"cuda"`` vqs and vqs-bf engines (J = 5, K = 32) and uncollapsed
    through bfjs-mr (K = 64, Qcap = 8192), each one launch of its own
    kernel with nothing truncated or dropped and equal to its host oracle
    (``simulate_trace``, ``simulate_mr_trace``) on the first ``TRACE_H``
    slots; then the four policies' ``"cuda"`` and ``"reference"`` engines
    on streams made on the card, equal on every field;
  * bfjs-mr path: ``monte_carlo_policy(..., policy="bfjs-mr",
    engine="cuda")`` — the same cluster with two resources (cpu, mem),
    each demand U[0.1, 0.9] independently, at offered load 0.8 per
    resource, Qcap = 1024, 128 members, 1000 slots;
  * best-fit path: ``best_fit_batched`` on 128 clusters of 1000 servers
    with bursts of 4096 jobs;
  * serve path: llama3-8b at full width (32 layers, d_model 4096, vocab
    128256, bf16, random weights from ``--seed``) behind
    ``ServingEngine(num_replicas=2, b_slots=4, c_max=2048, policy="bf")``
    answering 8 requests (prompts U[256, 1024] tokens, U[16, 64] new
    tokens, submitted at once, so the BF-J/S admission queue fills), then
    one ``prefill`` of 2048 tokens: the decode_attention kernel on every
    decode step, the flash_attention kernel on prefill.  Teacher-forced
    gates hold the model's decode with the kernels against decode with
    their plain versions, and prefill against the last decode step, in
    bf16 (before the path, on the weights and prompts of three seeds) and
    in float32 at the same width and depth on the prompt's first 64 tokens
    (after it).  A profile of one full-width decode step then splits its
    device time by kernel and gives the card's busy share;
  * Mamba2 path: the ssd_scan kernel against its plain version (the
    sequential recurrence) at the prefill shape below and the shapes of
    tests/test_kernels.py, then mamba2-130m at full width (24 layers,
    d_model 768, state 128, 24 heads of 64, vocab 50280, bf16, random
    weights from ``--seed``): gates holding ``forward`` / ``prefill``
    with the kernel against the token-by-token ``decode_step`` recurrence
    over every position of a 512-token prompt (two chunks) and against
    the plain chunked form, in float32 (the gate that decides) and in
    bf16, on three seeds each; then the same engine and 8-request traffic
    as the serve path, and one ``prefill`` at B = 4, S = 8192 (cut from
    32 x 32768): ssd_scan's three stage kernels on every prefill layer,
    no kernel on decode.  Profiles of the prefill (by kernel, then by
    operator and call site) and of one decode step follow.

Each path runs with every kernel's launch counter set to 0 just before it
and read just after; it must launch its own kernel and no other.  The
scheduler kernels are held to their plain versions on the first
``PLAIN_MEMBERS`` members and ``PLAIN_SLOTS`` slots of each path's
streams (the plain versions are bound by host launches a slot and set
most of the run's time; the slots were cut from 1000 to 250, and the
bench-shape comparisons' horizons halved (``BENCH_SLOTS``), when the
trace path came in, to keep the run inside its limit on a slow host).
Each phase prints its host seconds on a line of its own, and the "all phases
passed" line the total.  The second-to-last line of stdout is a JSON object
with one entry per kernel, eight, ssd_scan last (launches, error against the
plain version, kernel, plain, bound and library times; the attention
kernels' and SDPA's times are device times of a CUDA graph of calls, since
an eager decode call is bound by the host; best_fit's row adds ``ms_g1``,
the single-problem ``ops.best_fit`` at the same law); the last line is
``{"ok": true, "device": ...}``.  Any failed phase raises, and the script
exits non-zero without a result — also when no CUDA device is present.
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
#: bytes per second, float32 operations per second outside the tensor
#: cores (the scheduler kernels' compares and selects), and dense bf16 and
#: TF32 tensor-core operations per second (the attention products' type;
#: ssd_scan's split-TF32 products, three TF32 products for each float32
#: one).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12

#: Members and slots of the full-width streams the bfjs, VQS-family and
#: bfjs_mr kernels are held against their plain versions on: the kernel
#: and the plain version both run the first PLAIN_MEMBERS members over the
#: first PLAIN_SLOTS slots (members are independent and trajectories
#: causal, so that is an exact sub-problem; 250 slots are 2.5 mean
#: service times, the cluster ~92% filled).  The plain versions are bound
#: by host launches a slot, not by members, so the slots set their time.
#: Each kernel is held to ``monte_carlo_policy`` on all 128 members x
#: 1000 slots.
PLAIN_MEMBERS = 8
PLAIN_SLOTS = 250

#: Horizon of the bench-shape comparisons of phases 2, 3 and 3b (16
#: servers; ``benchmarks/sched_micro.py`` runs 2000 and 3000 slots), cut
#: for the same reason.
BENCH_SLOTS = 1000

#: Seeds whose weights and 256-token prompt the bf16 teacher-forced gate
#: runs on: ``--seed`` and the ones after it.
BF16_GATE_SEEDS = 3

#: Limits of the teacher-forced gates at llama3-8b's full width and depth,
#: as max |diff| / max |logit|.  float32 decides whether the kernels are
#: right: sound runs read at most 3.9e-6, and a 1% error in either
#: kernel's softmax scale reads 0.0097 or more.  bf16 is a sanity check
#: against gross faults: 32 layers of bf16 rounding put sound readings at
#: 0.015-0.021 with or without the kernels (seeds 0-5), so it cannot see
#: that 1% error (0.023-0.027), while a decode mask that drops the current
#: token reads 0.36-0.48.
GATE_TOL = {"bfloat16": 3e-2, "float32": 1e-4}


def uniform(lo: float, hi: float, R: int = 1):
    """A stream sampler of sizes (R == 1) or R-resource demands, each
    U[lo, hi], drawn with the stream's generator on its device."""
    import torch

    def sampler(gen, n, device):
        shape = (n,) if R == 1 else (n, R)
        return torch.rand(shape, generator=gen, device=device) \
            * (hi - lo) + lo
    return sampler


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


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph, replayed once to warm up and once under CUDA events, so the
    host's time to issue a call (the wrapper's Python, the launch) is not
    counted.  ``fn`` must be capturable."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def wall_ms(fn) -> tuple[float, object]:
    """Host-clock milliseconds of one synchronised call, and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work in ms, and which of bytes/operations sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


class PhaseClock:
    """Host seconds of each phase, printed on a line of its own as the
    phase ends, and of the whole run."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.last:.1f} s", flush=True)
        self.last = now

    def total(self) -> float:
        return time.perf_counter() - self.start


def bridge_phase(dev, seed: int, counters, reset_counters, L: int = 1000,
                 T: int = 1000, lam: float = 16.0, mu: float = 0.01) -> None:
    """The oracle bridge at the paper's width: ``engine="cuda"`` VQS and
    VQS-BF replay one trace (load 0.8 of L unit servers at mean size 0.5)
    and must equal the port's event-driven ``simulate_trace`` slot for
    slot, with nothing truncated or dropped, each launching its own kernel
    once and no other."""
    from repro_torch.core import VQS, VQSBF, simulate_trace
    from repro_torch.core.engine import run_policy_streams, streams_from_trace
    # the trace: Poisson(lam) arrivals a slot, sizes U[0.1, 0.9] in float64,
    # durations Geometric(mu)
    rng = np.random.default_rng(seed)
    slots = np.repeat(np.arange(T), rng.poisson(lam, T))
    sizes = rng.uniform(0.1, 0.9, len(slots))
    durs = rng.geometric(mu, len(slots))
    A_max = int(np.bincount(slots, minlength=T).max())
    print(f"bridge trace L={L} T={T} lam={lam} mu={mu}: {len(slots)} jobs, "
          f"at most {A_max} a slot")
    for policy, name, sched, extra in (
            ("vqs", "vqs", VQS, {}),
            ("vqs-bf", "vqs_bf", VQSBF, dict(work_steps=64))):
        t0 = time.perf_counter()
        ref = simulate_trace(sched(J=4), L=L, arrival_slots=slots,
                             sizes=sizes, durations=durs, horizon=T,
                             seed=seed, record_every=1)
        host_s = time.perf_counter() - t0
        st = streams_from_trace(slots, sizes, durs, horizon=T, device=dev)
        reset_counters()
        wall, res = wall_ms(lambda: run_policy_streams(
            st, policy=policy, engine="cuda", strict=True, J=4, L=L, K=16,
            Qcap=4096, A_max=A_max, **extra))
        launches = {n: c.count for n, c in counters.items()}
        tag = f"bridge {policy}"
        if int(res.truncated) or int(res.dropped):
            raise AssertionError(f"{tag}: truncated {int(res.truncated)}, "
                                 f"dropped {int(res.dropped)}")
        qlen = res.queue_len.cpu().numpy()
        if qlen.shape != ref.queue_lens.shape:
            raise AssertionError(f"{tag}: queue trajectory of shape "
                                 f"{qlen.shape}, oracle {ref.queue_lens.shape}")
        diff = np.flatnonzero(qlen != ref.queue_lens)
        if diff.size:
            t = int(diff[0])
            raise AssertionError(f"{tag}: queue length {int(qlen[t])} at slot "
                                 f"{t}, oracle {int(ref.queue_lens[t])}")
        if int(res.departed[-1]) != ref.departed:
            raise AssertionError(f"{tag}: {int(res.departed[-1])} departed, "
                                 f"oracle {ref.departed}")
        mean_q = float(qlen.mean())
        if policy == "vqs" and not mean_q > 0:
            raise AssertionError(f"{tag}: the queue never filled, so no "
                                 "packing burst was compared")
        if launches[name] != 1 or any(c for n, c in launches.items()
                                      if n != name):
            raise AssertionError(f"{tag}: launches {launches}, expected one "
                                 f"of {name} and no other")
        print(f"{tag} J=4 K=16 Qcap=4096 A_max={A_max}: equal to "
              f"simulate_trace slot for slot; oracle {host_s:.2f} s (host), "
              f"engine {wall:.1f} ms (wall, {name} launches 1); mean queue "
              f"{mean_q:.3f}; departed {ref.departed} of {ref.arrived}; "
              f"truncated 0, dropped 0")
        del st, res


#: The trace path's host-oracle horizons: the first H slots of the trace
#: (the trajectories are causal, so a prefix of the card's run is the run
#: of the prefix).  Each is past one mean duration (~4,950 slots), so
#: departures are compared on a full cluster.  At --seed 0 the first queue
#: forms at slot ~65,100 (the second diurnal peak; the long-tailed
#: durations keep the cluster filling past the first), so the vqs oracle
#: runs to 70,000 slots and compares packing and queue order there (43-53
#: s on the card's hosts); vqs-bf's oracle, 1.3x as costly, stops at
#: 40,000 and bfjs-mr's, which never queues on this trace, at 30,000.
#: Together they fit the phase's 150 s on a slow host.
TRACE_H = {"vqs": 70_000, "vqs-bf": 40_000, "bfjs-mr": 30_000}


def once_ms(fn) -> float:
    """CUDA-event milliseconds of one call (the caller has warmed it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def trace_phase(dev, seed: int, counters, reset_counters, card: str,
                n_tasks: int = 100_000, T: int = 130_000, L: int = 640,
                trace_h: dict | None = None) -> None:
    """The paper's Google-trace experiment (Section VII.B, Fig. 5) on the
    card, through the user's entry points with ``strict=True``.

    The port's ``synthesize_google_like_trace`` at ``benchmarks/fig5.py``'s
    full-scale per-task statistics and cluster (L = 640, mean duration
    6000, traffic scaling 1.0: offered load ~0.8), with tasks and horizon
    both cut 10x (the arrival density stays 0.77 a slot).  The collapsed
    max(cpu, mem) trace runs through the ``"cuda"`` vqs and vqs-bf engines
    (J = 5, K = 32: the K >= 2**J packing bound of
    ``examples/trace_replay.py``), the uncollapsed (cpu, mem) trace
    through bfjs-mr (K = 64, Qcap = 8192, ``work_steps`` 64); each run
    launches its own kernel once and no other, with nothing truncated or
    dropped, and its first ``trace_h[policy]`` slots equal the host
    oracle's (``simulate_trace(VQS(5))`` / ``VQSBF(5)``, and
    ``simulate_mr_trace(MultiResourceBFJS(640, 2))``).  Then the four
    policies' ``"cuda"`` and ``"reference"`` engines run on streams made on
    the card at the parity matrix's shapes and must be equal on every
    field."""
    from repro_torch.core import (VQS, VQSBF, collapse_resources,
                                  empirical_size_stats, simulate_trace,
                                  synthesize_google_like_trace)
    from repro_torch.core.engine import (Workload, monte_carlo_policy,
                                         run_policy_streams,
                                         streams_from_trace)
    from repro_torch.core.engine.bfjs import _batched
    from repro_torch.core.multi_resource import (MultiResourceBFJS,
                                                 simulate_mr_trace)
    from repro_torch.kernels.bfjs_mr.ops import bfjs_mr_simulate
    from repro_torch.kernels.vqs.ops import vqs_simulate
    from repro_torch.kernels.vqs_bf.ops import vqs_bf_simulate

    trace_h = trace_h or TRACE_H
    t_phase = time.perf_counter()
    trace = synthesize_google_like_trace(n_tasks, T, seed=seed,
                                         mean_duration=6000.0)
    sizes = collapse_resources(trace)
    demands = np.stack([trace.cpu, trace.mem], axis=1)
    stats = empirical_size_stats(sizes)
    print(f"trace: {len(trace)} tasks over {T} slots "
          f"({len(trace) / T:.4f} a slot), mean duration "
          f"{float(trace.durations.mean()):.1f} slots; collapsed sizes: "
          f"{stats['distinct_values']} distinct values (Fig. 1), mean "
          f"{stats['mean']:.4f}, p50 {stats['p50']:.4f}, p99 "
          f"{stats['p99']:.4f}, max {stats['max']:.4f}")
    collapsed = streams_from_trace(trace, horizon=T, device=dev)
    vector = streams_from_trace(trace, collapse=False, num_resources=2,
                                horizon=T, device=dev)
    A_max = int(collapsed.sizes.shape[1])
    paths = (
        ("vqs", "vqs", collapsed, vqs_simulate,
         dict(J=5, L=L, K=32, Qcap=1 << 15, A_max=A_max)),
        ("vqs-bf", "vqs_bf", collapsed, vqs_bf_simulate,
         dict(J=5, L=L, K=32, Qcap=1 << 15, A_max=A_max, work_steps=64)),
        ("bfjs-mr", "bfjs_mr", vector, bfjs_mr_simulate,
         dict(L=L, K=64, Qcap=8192, A_max=A_max, work_steps=64)))
    for policy, name, st, kernel, cfg in paths:
        tag = f"trace {policy}"
        reset_counters()
        wall, res = wall_ms(lambda: run_policy_streams(
            st, policy=policy, engine="cuda", strict=True, **cfg))
        launches = {n: c.count for n, c in counters.items()}
        if launches[name] != 1 or any(c for n, c in launches.items()
                                      if n != name):
            raise AssertionError(f"{tag}: launches {launches}, expected one "
                                 f"of {name} and no other")
        if int(res.truncated) or int(res.dropped):
            raise AssertionError(f"{tag}: truncated {int(res.truncated)}, "
                                 f"dropped {int(res.dropped)}")
        extra = {"capacity": (1.0, 1.0)} if policy == "bfjs-mr" else {}
        k_ms = once_ms(lambda: kernel(_batched(st), **cfg, **extra))
        qlen = res.queue_len.cpu().numpy()
        busy = np.flatnonzero(qlen > 0)
        print(f"{tag} L={L} T={T} {cfg}: engine {wall:.1f} ms (wall), "
              f"kernel {k_ms:.1f} ms; {name} launches 1; mean queue "
              f"{float(qlen.mean()):.4f} (max {int(qlen.max())}, first "
              f"queued slot {int(busy[0]) if busy.size else None}); departed "
              f"{int(res.departed[-1])} of {len(trace)}; truncated 0, "
              f"dropped 0 [{card}]")

        H = trace_h[policy]
        m = trace.arrival_slots < H
        t0 = time.perf_counter()
        if policy == "bfjs-mr":
            ref = simulate_mr_trace(MultiResourceBFJS(L, 2),
                                    trace.arrival_slots[m], demands[m],
                                    trace.durations[m], horizon=H)
            want = {"queue_len": ref.queue_lens,
                    "occupancy": ref.extras["occupancy"].astype(np.float32),
                    "departed": ref.extras["departed_cum"]}
        else:
            sched = VQS if policy == "vqs" else VQSBF
            ref = simulate_trace(sched(J=5), L=L,
                                 arrival_slots=trace.arrival_slots[m],
                                 sizes=sizes[m], durations=trace.durations[m],
                                 horizon=H, seed=seed, record_every=1)
            want = {"queue_len": ref.queue_lens,
                    "departed": np.array([ref.departed])}
        host_s = time.perf_counter() - t0
        for f, w in want.items():
            got = getattr(res, f).cpu().numpy()[:H]
            if f == "departed" and policy != "bfjs-mr":
                got = got[-1:]
            diff = np.flatnonzero((got != w).reshape(len(w), -1).any(1))
            if diff.size:
                t = int(diff[0])
                raise AssertionError(f"{tag}: {f} differs from the oracle "
                                     f"first at slot {t} of {H}")
        print(f"{tag}: equal to the host oracle on slots 0..{H - 1} "
              f"(H = {H}; {', '.join(want)}); oracle {host_s:.2f} s "
              f"(host); mean queue over H {float(qlen[:H].mean()):.4f}; "
              f"departed {int(res.departed[H - 1])} of "
              f"{int(m.sum())} arrived [{card}]")
        del res

    # the oracles meet the kernels directly: "cuda" and "reference" on
    # streams made on the card, at the parity matrix's shapes
    matrix = {
        "bfjs": (Workload(lam=1.2, mu=0.05, sampler=uniform(0.05, 0.5)),
                 dict(L=4, K=6, Qcap=64, A_max=5, horizon=150)),
        "vqs": (Workload(lam=1.0, mu=0.05, sampler=uniform(0.05, 0.5)),
                dict(L=4, K=8, Qcap=64, A_max=5, horizon=150, J=3)),
        "bfjs-mr": (Workload(lam=0.5, mu=0.05,
                             sampler=uniform(0.05, 0.5, 2),
                             num_resources=2, capacity=(1.0, 0.75)),
                    dict(L=4, K=8, Qcap=64, A_max=5, horizon=150,
                         work_steps=24)),
        "vqs-bf": (Workload(lam=1.0, mu=0.05, sampler=uniform(0.05, 0.5)),
                   dict(L=4, K=8, Qcap=64, A_max=5, horizon=150, J=3,
                        work_steps=48))}
    for policy, (wl, cfg) in matrix.items():
        seeds = [seed, seed + 1]
        t0 = time.perf_counter()
        ref = monte_carlo_policy(wl, seeds, policy=policy,
                                 engine="reference", device=dev, **cfg)
        host_s = time.perf_counter() - t0
        got = monte_carlo_policy(wl, seeds, policy=policy, engine="cuda",
                                 strict=True, device=dev, **cfg)
        if got.queue_len.device != ref.queue_len.device \
                or ref.queue_len.device.type != dev.type:
            raise AssertionError(f"{policy}: a result left the card")
        require_equal(f"{policy} cuda vs reference on card-made streams",
                      got, ref)
        print(f"{policy} cuda == reference on card-made streams ({cfg}, "
              f"seeds {seeds}): every field equal; mean queue "
              f"{float(ref.queue_len.double().mean()):.3f}, truncated "
              f"{int(got.truncated.sum())}; oracle {host_s:.2f} s (host) "
              f"[{card}]")
    print(f"trace phase: {time.perf_counter() - t_phase:.1f} s [{card}]")


ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def attn_check(what: str, got, ref) -> float:
    """Hold an attention kernel's output to its plain version within the
    tolerance of tests/test_kernels.py (|a - b| <= tol + tol |b|); returns
    the max abs error."""
    tol = ATTN_TOL[str(got.dtype).removeprefix("torch.")]
    a, b = got.double(), ref.double()
    err = float((a - b).abs().max())
    if not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
        raise AssertionError(f"{what}: max abs err {err:.3g} against the "
                             f"plain version, over the tolerance {tol}")
    return err


def decode_valid_rows(pos, C: int, window: int) -> list[int]:
    """Valid cache rows per batch row for the decode mask."""
    return [min(p + 1, C, window) if window else min(p + 1, C) for p in pos]


def decode_phase(dev, seed: int) -> dict:
    """decode_attention kernel against its plain version at the serve
    path's shape (window 0 and 512) and the f32 sweep of
    tests/test_kernels.py; timings at the serve shape, window 0: the
    kernel and SDPA in device time (``device_ms``), the kernel's eager call
    on the host clock beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(seed)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    B, H, KV, C, hd = 4, 32, 8, 2048, 128
    pos = (0, 511, 1337, 2047)
    q = normal((B, H, hd), torch.bfloat16)
    k = normal((B, KV, C, hd), torch.bfloat16)
    v = normal((B, KV, C, hd), torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    cs = da.cluster_size(B, H, KV, C)
    units = B * KV * -(-(H // KV) // 4)
    print(f"decode_attention instance: clusters of {cs} blocks, one per "
          f"(row, kv head, group of 4 query heads): {units * cs} blocks, the "
          "split over the cache merged in the same launch")
    row = {}
    for window in (0, 512):
        got = da.decode_attention_cuda(q, k, v, p, window=window)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, p, window=window)
        err = attn_check(f"decode_attention window={window}", got, ref)
        ms = device_ms(lambda: da.decode_attention_cuda(q, k, v, p,
                                                        window=window), 50)
        call_ms = time_ms(lambda: da.decode_attention_cuda(q, k, v, p,
                                                           window=window), 50)
        plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, p,
                                                        window=window), 5)
        rows_valid = decode_valid_rows(pos, C, window)
        nbytes = 2 * (sum(rows_valid) * KV * hd * 2 + 2 * B * H * hd)
        ops = 4 * hd * H * sum(rows_valid)
        b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
        c_pos = torch.arange(C, device=dev)
        mask = c_pos[None] <= p[:, None].long()
        if window:
            mask &= c_pos[None] > p[:, None].long() - window
        qs, mask = q[:, :, None], mask[:, None, None]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True), 50)
        print(f"decode_attention B={B} H={H} KV={KV} C={C} hd={hd} bf16 "
              f"pos={pos} window={window}: max abs err {err:.3g} vs plain "
              f"(tol 2e-2); kernel {ms:.4f} ms device ({call_ms:.4f} ms an "
              f"eager call), plain {plain_ms:.4f} ms, library (SDPA, boolean "
              f"mask) {lib_ms:.4f} ms device, bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes} B)")
        if window == 0:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    for C32, pos32, w32 in ((256, 0, 0), (256, 255, 0), (512, 300, 128)):
        q32 = normal((2, 8, 64), torch.float32)
        k32 = normal((2, 2, C32, 64), torch.float32)
        v32 = normal((2, 2, C32, 64), torch.float32)
        got = da.decode_attention_cuda(q32, k32, v32, pos32, window=w32)
        torch.cuda.synchronize()
        err = attn_check(f"decode_attention f32 C={C32}", got,
                         decode_attention_ref(q32, k32, v32, pos32,
                                              window=w32))
        print(f"decode_attention B=2 H=8 KV=2 C={C32} hd=64 f32 pos={pos32} "
              f"window={w32}: max abs err {err:.3g} vs plain (tol 2e-5)")
    return row


#: Limit of the bf16 flash check at the serve shape: max |diff| / max |out|
#: against the plain version's float32 output.  Sound kernels read
#: 0.0025-0.0027 (bf16 rounding of P and of the output); a 1% error in the
#: softmax scale reads 0.0087, which the 2e-2 absolute check passes
#: (PERF.md, section 6).
FLASH_BF16_REL_TOL = 5e-3


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in float64."""
    a, b = got.double(), ref.double()
    return float((a - b).abs().max()) / float(b.abs().max())


def flash_phase(dev, seed: int) -> dict:
    """flash_attention kernel against its plain version at llama3-8b's
    prefill shape (causal, window 0 and 512) and the f32 sweep of
    tests/test_kernels.py.  The bf16 inputs are the model's: (B, S, H, hd)
    views transposed to (B, H, S, hd).  Timings at window 0: the kernel
    and SDPA in device time (``device_ms``), the kernel's eager call on
    the host clock beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(seed + 1)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    B, H, KV, S, hd = 1, 32, 8, 2048, 128
    q = normal((B, S, H, hd), torch.bfloat16).transpose(1, 2)
    k = normal((B, S, KV, hd), torch.bfloat16).transpose(1, 2)
    v = normal((B, S, KV, hd), torch.bfloat16).transpose(1, 2)
    print(f"flash_attention instance: {fa.instance(q.dtype, hd)} (bf16, "
          f"hd={hd}), strided (B, S, H, hd) views in and out")
    row = {}
    for window in (0, 512):
        got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        if got.stride() != q.stride():
            raise AssertionError("flash_attention: the output does not "
                                 "keep q's strides")
        ref = attention_ref(q, k, v, causal=True, window=window)
        err = attn_check(f"flash_attention window={window}", got, ref)
        # the plain version's float32 output, unrounded: the check sees the
        # kernel's error, not two roundings to bf16
        ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                            window=window)
        rel = rel_err(got, ref)
        diff = (got.double() - ref.double())
        rms = float(diff.pow(2).mean().sqrt()) / float(
            ref.double().pow(2).mean().sqrt())
        del ref, diff
        if not rel <= FLASH_BF16_REL_TOL:
            raise AssertionError(f"flash_attention window={window}: max "
                                 f"|diff| / max |out| {rel:.4g} over "
                                 f"{FLASH_BF16_REL_TOL}")
        ms = device_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=window), 10)
        call_ms = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True, window=window), 10)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                 window=window), 3)
        pairs = sum(min(i + 1, window) if window else i + 1
                    for i in range(S))
        nbytes = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
        ops = 4 * hd * pairs * B * H
        b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
        line = (f"flash_attention B={B} H={H} KV={KV} S={S} hd={hd} bf16 "
                f"causal window={window}: max abs err {err:.3g} vs plain "
                f"(tol 2e-2); against the float32 plain output max |diff| / "
                f"max |out| {rel:.4g} (limit "
                f"{FLASH_BF16_REL_TOL:g}), rms |diff| / rms |out| {rms:.4g}; "
                f"kernel {ms:.4f} ms device ({call_ms:.4f} ms an eager call, "
                f"{ops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {ops:.4g} operations at "
                f"{BF16_TC_OPS_PER_S:.4g}/s)")
        if window == 0:
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10)
            line += f", library (SDPA is_causal) {lib_ms:.4f} ms device"
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        print(line)
    for S32, hd32, w32 in ((128, 64, 0), (256, 64, 0), (256, 128, 64)):
        q32 = normal((2, 4, S32, hd32), torch.float32)
        k32 = normal((2, 2, S32, hd32), torch.float32)
        v32 = normal((2, 2, S32, hd32), torch.float32)
        got = fa.flash_attention_cuda(q32, k32, v32, causal=True, window=w32)
        torch.cuda.synchronize()
        err = attn_check(f"flash_attention f32 S={S32}", got,
                         attention_ref(q32, k32, v32, causal=True,
                                       window=w32))
        print(f"flash_attention B=2 H=4 KV=2 S={S32} hd={hd32} f32 causal "
              f"window={w32} ({fa.instance(q32.dtype, hd32)} instance): max "
              f"abs err {err:.3g} vs plain (tol 2e-5)")
    return row


def teacher_forced(cfg, params, prompt) -> dict[str, float]:
    """Feed ``prompt`` (1, P) through ``decode_step`` and through
    ``prefill``, once with the kernels and once with their plain versions
    (same weights).  Returns, each as max |diff| / max |logit|: decode with
    the kernels against decode with the plain versions over all P steps
    (``kernels``), prefill against the last decode step with the kernels
    (``prefill``), and the same with the plain versions (``floor``: the
    model's own rounding, no kernel in it)."""
    import torch
    from repro_torch.models import model as M
    P = prompt.shape[1]
    logits, last = {}, {}
    for use in (True, False):
        caches = M.init_cache(cfg, 1, P, device=prompt.device)
        steps = []
        for i in range(P):
            out, caches = M.decode_step(params, cfg, prompt[:, i:i + 1], i,
                                        caches, use_kernels=use)
            steps.append(out[:, 0])
        logits[use] = torch.cat(steps)                    # (P, V)
        last[use] = M.prefill(params, cfg, tokens=prompt, use_kernels=use)[0]
        del caches

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    return dict(kernels=rel(logits[True], logits[False]),
                prefill=rel(last[True], logits[True][-1]),
                floor=rel(last[False], logits[False][-1]))


def gate_on_seed(cfg, dev, seed: int, P: int) -> None:
    """The teacher-forced gate at full width on ``seed``'s weights and the
    first P tokens of its 256-token prompt: ``kernels`` and ``prefill``
    (``teacher_forced``) must be within ``GATE_TOL`` of the dtype."""
    import torch
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 256))
                              .astype(np.int64)).to(dev)[:, :P]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    r = teacher_forced(cfg, params, prompt)
    del params
    torch.cuda.empty_cache()
    tol = GATE_TOL[cfg.dtype]
    tag = f"{'bf16' if cfg.dtype == 'bfloat16' else 'f32'} seed {seed}"
    print(f"serve: teacher-forced {P}-token prompt, {tag} {cfg.num_layers} "
          f"layers: decode with kernels vs plain versions max |diff| / max "
          f"|logit| = {r['kernels']:.4g} over all {P} steps; prefill (flash) "
          f"vs last decode step {r['prefill']:.4g} (gate {tol:g} each); "
          f"the same with the plain versions {r['floor']:.4g}")
    if not r["kernels"] <= tol or not r["prefill"] <= tol:
        raise AssertionError(f"serve: {tag} teacher-forced gate failed")


def profile_decode_step(cfg, params, dev, tag: str = "serve") -> None:
    """Where a full-width decode step's time goes: the host time to issue
    one step of the serve path's 4 rows, at spread positions of a
    2048-entry cache, against the step's synchronised time, then the
    device time of 5 steps by kernel under ``torch.profiler`` and the
    card's busy share of that window."""
    import torch
    from repro_torch.models import model as M
    B, C, steps = 4, 2048, 5
    caches = M.init_cache(cfg, B, C, device=dev)
    tok = torch.ones((B, 1), dtype=torch.int64, device=dev)
    pos = torch.linspace(0, C // 2, B, device=dev).to(torch.int32)

    def step():
        M.decode_step(params, cfg, tok, pos, caches)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    with profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(f"{tag} profile: decode step B={B} C={C} positions {pos.tolist()}: "
          f"enqueued in {issued * 1e3:.2f} ms, done in {done * 1e3:.2f} ms "
          f"(host clock)")
    device_split(tag, prof, wall_us, steps, "step")


def profile_prefill(cfg, params, dev, tokens, tag: str = "mamba") -> None:
    """Where a prefill's time goes: the device time of one ``prefill`` of
    ``tokens`` (after a warm-up) by kernel under ``torch.profiler``, and
    the card's busy share of that window."""
    import torch
    from repro_torch.models import model as M
    M.prefill(params, cfg, tokens=tokens)
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        M.prefill(params, cfg, tokens=tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    B, S = tokens.shape
    print(f"{tag} profile: prefill B={B} S={S}")
    device_split(tag, prof, wall_us, 1, "prefill")
    with profiled(stack=True) as prof:
        M.prefill(params, cfg, tokens=tokens)
        torch.cuda.synchronize()
    call_site_split(tag, prof, "prefill")


def profiled(stack: bool = False):
    """A ``torch.profiler`` context recording host and device activity
    (and, with ``stack``, the Python stack of each operator: the verbose
    experimental config is what fills ``stack``)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA], with_stack=stack,
        experimental_config=_ExperimentalConfig(verbose=stack))


def call_site(stack, frames: int = 2) -> str:
    """The innermost ``frames`` frames of a profiler stack inside the port
    (``path(line): function`` from ``repro_torch/`` on, innermost first)."""
    names = [f.split("repro_torch/", 1)[-1] for f in stack
             if "repro_torch/" in f]
    return " < ".join(names[:frames]) or "(outside the port)"


def call_site_split(tag: str, prof, unit: str, top: int = 14,
                    depth: int = 8) -> None:
    """The device time of one ``unit`` under ``prof`` (recorded with
    stacks) by operator and call site in the port: each operator's self
    device time (the kernels it launched itself), grouped by
    ``key_averages(group_by_stack_n=depth)`` and summed by the operator's
    name and :func:`call_site`.  Kernels launched through ctypes have no
    operator and are counted apart."""
    import torch
    sites: dict[str, float] = {}
    for e in prof.key_averages(group_by_stack_n=depth):
        if e.device_type != torch.autograd.DeviceType.CPU or \
                e.self_device_time_total <= 0:
            continue
        key = f"{e.key} at {call_site(e.stack)}"
        sites[key] = sites.get(key, 0.0) + e.self_device_time_total
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy == 0:
        print(f"{tag} call sites: the profiler recorded no device time: "
              "device time not measured")
        return
    named = sum(sites.values())
    print(f"{tag} call sites: {busy / 1e3:.2f} ms of device time per {unit}, "
          f"{named / 1e3:.2f} ms under PyTorch operators, "
          f"{(busy - named) / 1e3:.2f} ms in kernels launched without one "
          f"(ctypes)")
    for key, us in sorted(sites.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{tag} call sites:  {us / 1e3:8.3f} ms {us / busy:6.1%}  "
              f"{key[:150]}")


def device_split(tag: str, prof, wall_us: float, reps: int,
                 unit: str) -> None:
    """Print the device time of ``reps`` runs of one ``unit`` recorded by
    ``prof`` in a ``wall_us`` window: the busy share, the time per run,
    the matrix products' share and the ten largest kernels."""
    import torch
    times: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total
            launches += e.count
    busy = sum(times.values())
    if busy == 0:
        print(f"{tag} profile: the profiler recorded no device time: device "
              "time not measured")
        return
    print(f"{tag} profile: {reps} x {unit} under the profiler: wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({busy / wall_us:.1%}); per {unit} {busy / reps / 1e3:.2f} ms of "
          f"device time in {launches // reps} kernel launches")
    gemm = sum(us for name, us in times.items()
               if "nvjet" in name or "gemm" in name.lower())
    print(f"{tag} profile: matrix products (cuBLAS kernels) "
          f"{gemm / reps / 1e3:.3f} ms/{unit} ({gemm / busy:.1%})")
    for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:10]:
        print(f"{tag} profile:  {us / reps / 1e3:8.3f} ms/{unit} "
              f"{us / busy:6.1%}  {name[:90]}")


def timed_engine(cfg, params, dev):
    """The serve paths' engine, ``ServingEngine(num_replicas=2, b_slots=4,
    c_max=2048, policy="bf", audit=True)``, with each replica's decode
    timed on the host clock (it ends in the greedy tokens' copy to the
    host); returns the engine and the list the times go to."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(cfg, params, num_replicas=2, b_slots=4,
                           c_max=2048, policy="bf", audit=True, device=dev)
    decode_s = []
    for rep in engine.replicas:
        def timed(toks, positions, _decode=rep.decode):
            t0 = time.perf_counter()
            out = _decode(toks, positions)          # ends in a host copy
            decode_s.append(time.perf_counter() - t0)
            return out
        rep.decode = timed
    return engine, decode_s


def serve_requests(rng, vocab: int) -> list:
    """The serve paths' traffic: 8 requests, prompts U[256, 1024] tokens,
    U[16, 64] new tokens, submitted at once."""
    from repro_torch.serving.engine import Request
    lengths = rng.integers(256, 1025, 8)       # drawn before the tokens,
    max_new = rng.integers(16, 65, 8)          # so they do not depend on
    return [Request(rid=i, prompt=rng.integers(  # the vocabulary size
                1, vocab, int(n)).astype(np.int32), max_new=int(m))
            for i, (n, m) in enumerate(zip(lengths, max_new))]


def check_served(tag: str, cfg, engine, done) -> None:
    """Every request completed with its tokens, in the vocabulary, and the
    admission queue filled."""
    if len(done) != 8 or any(len(r.out) != r.max_new for r in done):
        raise AssertionError(f"{tag}: not every request completed with its "
                             "max_new tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError(f"{tag}: a generated token is out of the vocab")
    if not max(engine.stats["queue_len"]) > 0:
        raise AssertionError(f"{tag}: the admission queue never filled")


def serve_path(dev, seed: int, counters, reset_counters) -> dict:
    """The LM serving path at llama3-8b's full width; returns the two
    attention kernels' launches in the path's run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")

    # -- teacher-forced gates (GATE_TOL): kernels vs plain versions, prefill
    # vs decode; the float32 one follows the path
    for s in range(seed, seed + BF16_GATE_SEEDS):
        gate_on_seed(cfg, dev, s, 256)
    torch.cuda.reset_peak_memory_stats()
    init_ms, params = wall_ms(lambda: M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    n_params = sum(x.numel() for x in [params["embed"]["w"],
                                       params["head"]["w"]]) + sum(
        x.numel() for layer in params["layers"]
        for part in layer.values() for x in part.values())
    print(f"serve: llama3-8b {cfg.num_layers} layers d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size} {cfg.dtype}: {n_params / 1e9:.3f} B "
          f"parameters drawn on the card in {init_ms / 1e3:.1f} s")

    # -- the path: engine + one prefill at S = 2048 --------------------------
    rng = np.random.default_rng(seed)
    rng.integers(1, cfg.vocab_size, (1, 256))     # the gates' prompt first
    engine, decode_s = timed_engine(cfg, params, dev)
    reqs = serve_requests(rng, cfg.vocab_size)
    frac = sum(r.tokens_needed for r in reqs) / 2048
    long_prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, 2048)).astype(np.int64)).to(dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.submit(reqs)
    done = engine.run(max_steps=20_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefill_wall_ms, out = wall_ms(lambda: M.prefill(params, cfg,
                                                     tokens=long_prompt))
    launches = {n: c.count for n, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ticks = len(engine.stats["queue_len"])
    calls = len(decode_s)
    check_served("serve", cfg, engine, done)
    if launches["decode_attention"] != cfg.num_layers * calls \
            or launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"serve: launches {launches}, expected "
                             f"{cfg.num_layers} per decode call ({calls}) "
                             f"and {cfg.num_layers} for the prefill")
    if any(c for n, c in launches.items()
           if n not in ("decode_attention", "flash_attention")):
        raise AssertionError(f"serve: unexpected launches {launches}")
    if out.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(out)
                                                   .all()):
        raise AssertionError("serve: prefill logits bad shape or values")
    generated = sum(len(r.out) for r in done)
    processed = sum(r.pos for r in done)
    prefill_ms = time_ms(lambda: M.prefill(params, cfg, tokens=long_prompt),
                         3)
    print(f"serve path: 8 requests, KV demand {frac:.3f} replicas of 2, "
          f"max queue {max(engine.stats['queue_len'])}, admitted "
          f"{engine.stats['admitted']}, slot rejections "
          f"{engine.stats['rejected_slots']}; {ticks} ticks, {calls} "
          f"replica decode steps in {wall:.2f} s; generated {generated} "
          f"tokens ({generated / wall:.1f} tokens/s), processed {processed} "
          f"tokens ({processed / wall:.1f} tokens/s); decode step "
          f"{np.mean(decode_s) * 1e3:.2f} ms mean per replica tick (host "
          f"clock, synchronised); prefill S=2048 {prefill_wall_ms:.1f} ms "
          f"in the path, {prefill_ms:.1f} ms (CUDA events, mean of 3); "
          f"device memory peak {peak_gb:.2f} GB; launches "
          f"decode_attention {launches['decode_attention']} "
          f"({launches['decode_attention'] // calls} per replica tick), "
          f"flash_attention {launches['flash_attention']}")
    del engine
    profile_decode_step(cfg, params, dev)
    del params
    torch.cuda.empty_cache()

    # the same gates in float32 at full width and depth, on the prompt's
    # first 64 tokens: here the kernels and the model must agree to float32
    # precision, not to bf16's
    gate_on_seed(cfg.with_(dtype="float32"), dev, seed, 64)
    return launches


#: Tolerance of the ssd_scan kernel against its plain version (the
#: sequential recurrence), |a - b| <= atol + rtol |b|: tests/test_kernels.py's.
SSD_TOL = {"float32": (1e-4, 1e-2), "bfloat16": (5e-2, 1e-2)}

#: Limits of the Mamba2 gates at mamba2-130m's full width and depth, as
#: max |diff| / max |logit| over a 512-token prompt: ``forward`` with the
#: kernel against the token-by-token recurrence (``recurrence``),
#: ``prefill`` against the last decode step (``prefill``), and ``forward``
#: with the kernel against the plain chunked form (``plain``).  float32
#: decides: sound runs read at most 5.5e-6, and a kernel that drops the
#: inter-chunk term or shifts the cumsum by one position reads 0.026 or
#: more.  In bf16, 24 layers of rounding put the recurrence readings at
#: 0.033-0.044 with or without the kernel, where those faults also fall,
#: so those two are a sanity check against gross faults; ``plain`` (sound
#: 0.022-0.024, the faults 0.045-0.047) still sees them.  Seeds 0-2 and
#: the faults: PERF.md, section 6.
MAMBA_GATE_TOL = {
    "float32": {"recurrence": 1e-4, "prefill": 1e-4, "plain": 1e-4},
    "bfloat16": {"recurrence": 7e-2, "prefill": 7e-2, "plain": 3.5e-2}}
MAMBA_GATE_SEEDS = 3


def ssd_work(B, H, G, nc, Lc, hd, N, bc_size=4) -> tuple[float, float,
                                                          float]:
    """Bytes and operations of one ssd_scan call, x, a and y float32 and B
    and C of ``bc_size`` bytes.  Bytes: xdt and a read once, Bm and Cm (G
    groups) read once, y written once.  Operations per chunk and head,
    over the causal pairs j <= i only (as flash_phase counts them): C B^T
    Lc (Lc + 1) N, P x Lc (Lc + 1) hd, C S^T and the state update 2 Lc hd
    N each.  Also the TF32 tensor-core operations the kernels issue for
    them: three products each in split TF32, two for C S^T and one for
    C B^T where B and C are bf16 (exact in TF32, no lo terms)."""
    nbytes = nc * Lc * B * (4 * H * (2 * hd + 1) + bc_size * G * 2 * N)
    scores = B * H * nc * Lc * (Lc + 1) * N
    px = B * H * nc * Lc * (Lc + 1) * hd
    cst = update = B * H * nc * 2 * Lc * hd * N
    ops = scores + px + cst + update
    tf32 = 3 * ops if bc_size == 4 else scores + 3 * px + 2 * cst + 3 * update
    return nbytes, ops, tf32


def ssd_state_bytes(B, H, nc, hd, N) -> float:
    """Bytes the stages move through device memory beside the call's own:
    the float32 chunk states written (stage 1), read and written over
    (stage 2) and read (stage 3)."""
    return 4 * 4.0 * B * H * nc * hd * N


def tensor_core_check(name: str, kernels: tuple[str, ...]) -> dict:
    """The tensor-core instructions (SASS HMMA / HGMMA) in each instance of
    the built library's kernel functions named in ``kernels``; raises if
    an instance has none.  Returns, per kernel, the instances and the
    least count among them, and the counts of the instances with hd = 64
    and N = 128 (the ones that serve mamba2-130m), by type of B and C."""
    from repro_torch.kernels import build
    counts = build.tensor_core_counts(name)
    found = {}
    for k in kernels:
        inst = {f: n for f, n in counts.items() if k + "I" in f}
        if not inst or not all(inst.values()):
            raise AssertionError(f"{name}: an instance of {k} has no "
                                 "tensor-core instruction")
        found[k] = dict(instances=len(inst), least=min(inst.values()), **{
            ("bf16" if "bfloat16" in f else "float32"): n
            for f, n in inst.items() if "Li64ELi128E" in f})
    return found


def ssd_check(what: str, got, ref) -> tuple[float, float]:
    """Hold the ssd_scan kernel to its plain version within ``SSD_TOL``;
    returns the max abs error and max |diff| / max |y|."""
    atol, rtol = SSD_TOL[str(got.dtype).removeprefix("torch.")]
    a, b = got.double(), ref.double()
    diff = (a - b).abs()
    err, rel = float(diff.max()), float(diff.max() / b.abs().max())
    if not bool((diff <= atol + rtol * b.abs()).all()):
        raise AssertionError(f"{what}: max abs err {err:.3g} against the "
                             f"plain version, over atol {atol} rtol {rtol}")
    return err, rel


def ssd_phase(dev, seed: int) -> dict:
    """ssd_scan against its plain version (the recurrence) at the Mamba2
    path's prefill shape (B = 4, S = 8192 in 32 chunks of 256,
    mamba2-130m's 24 heads of 64 reading one group of N = 128) twice: as
    ``mamba_apply`` gives it in bf16, float32 x and a with bf16 B and C,
    each a view of the model's layout (the instance the path runs), and
    all float32, contiguous; then at the shapes of tests/test_kernels.py
    (per-head B and C) and with two groups of two heads.  At the prefill
    shape also each stage kernel against its plain version, the timings
    of the call and of each stage, and the bounds.  Returns the kernels
    line's row: the path's instance, the float32 one under ``float32``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    tc = tensor_core_check("ssd_scan", ("chunk_states_kernel",
                                        "chunk_scan_kernel"))
    print(f"ssd_scan: tensor-core instructions (SASS HMMA) in the built "
          f"library, per kernel: instances, the least in one, and the "
          f"hd = 64, N = 128 instances by type of B and C: {tc}")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, H, G, nc, Lc, hd, N, dtype):
        return ((normal(B, H, nc, Lc, hd) * 0.5).to(dtype),
                (normal(B, G, nc, Lc, N) * 0.5).to(dtype),
                (normal(B, G, nc, Lc, N) * 0.5).to(dtype),
                (-F.softplus(normal(B, H, nc, Lc))).to(dtype))

    def model_inputs(B, H, G, nc, Lc, hd, N):
        """As mamba_apply passes them in bf16: x (B, S, H, hd) and a
        (B, S, H) float32, B and C bf16 slices of the conv output (B, S,
        H hd + 2 G N), each viewed as (B, H or G, nc, Lc, *)."""
        S, din = nc * Lc, H * hd
        xbc = (normal(B, S, din + 2 * G * N) * 0.5).to(torch.bfloat16)

        def groups(t):
            return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
        return ((normal(B, S, H, hd) * 0.5).reshape(B, nc, Lc, H, hd)
                .permute(0, 3, 1, 2, 4),
                groups(xbc[..., din:din + G * N]),
                groups(xbc[..., din + G * N:]),
                (-F.softplus(normal(B, S, H))).reshape(B, nc, Lc, H)
                .permute(0, 3, 1, 2))

    prefill = (4, 24, 1, 32, 256, 64, 128)
    timed = {}
    for shape, dtype, tag in (
            (prefill, None, "f32 x, bf16 B C, model layout"),
            (prefill, torch.float32, "f32"),
            ((2, 3, 3, 2, 32, 16, 8), torch.float32, "f32"),
            ((2, 3, 3, 4, 64, 32, 16), torch.float32, "f32"),
            ((2, 3, 3, 4, 64, 64, 32), torch.bfloat16, "bf16"),
            ((1, 1, 1, 8, 16, 8, 4), torch.float32, "f32"),
            ((2, 4, 2, 3, 16, 16, 16), torch.float32, "f32")):
        B, H, G, nc, Lc, hd, N = shape
        args = model_inputs(*shape) if dtype is None else \
            inputs(*shape, dtype)
        got = sk.ssd_scan_cuda(*args)
        torch.cuda.synchronize()
        ref = ssd_ref(*args)
        what = (f"ssd_scan B={B} H={H} G={G} nc={nc} Lc={Lc} hd={hd} N={N} "
                f"{tag}")
        err, rel = ssd_check(what, got, ref)
        atol, rtol = SSD_TOL[str(got.dtype).removeprefix("torch.")]
        line = (f"{what}: max abs err {err:.3g}, max |diff| / max |y| "
                f"{rel:.3g} vs plain (atol {atol:g}, rtol {rtol:g})")
        if shape == prefill:
            ms = time_ms(lambda: sk.ssd_scan_cuda(*args), 10)
            plain_ms = time_ms(lambda: ssd_ref(*args), 1)
            bc_size = args[1].element_size()
            nbytes, ops, tf32 = ssd_work(*shape, bc_size)
            b_ms, b_by = bound(nbytes, tf32, TF32_TC_OPS_PER_S)
            fp32_ms, _ = bound(nbytes, ops)
            state_gb = ssd_state_bytes(B, H, nc, hd, N) / 1e9
            with_states = (nbytes / 1e9 + state_gb) * 1e12 / HBM_BYTES_PER_S
            line += (f"; call {ms:.4f} ms, plain {plain_ms:.1f} ms; bound "
                     f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.3f} GB at "
                     f"{HBM_BYTES_PER_S:.3g} B/s = "
                     f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                     f"{state_gb:.3f} GB more of chunk states = "
                     f"{with_states:.4f} ms; {tf32 / 1e9:.1f} GFLOP of TF32 "
                     f"products for {ops / 1e9:.1f} GFLOP at "
                     f"{TF32_TC_OPS_PER_S:.3g}/s = "
                     f"{tf32 / TF32_TC_OPS_PER_S * 1e3:.4f} ms); the "
                     f"float32 CUDA-core bound {fp32_ms:.4f} ms "
                     f"({ops / 1e9:.1f} GFLOP at {FP32_OPS_PER_S:.3g}/s)")
            print(line)
            stages = ssd_stage_check(args, sk, sref)
            timed[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=None,
                              bound_fp32_ms=fp32_ms, stage_ms=stages)
        else:
            print(line)
        del args, got, ref
    torch.cuda.empty_cache()
    row, f32 = timed.values()
    return dict(row, float32=f32)


def ssd_stage_check(args, sk, sref) -> dict[str, float]:
    """Each ssd_scan stage kernel against its plain version on the same
    inputs (within ``SSD_TOL``; the state pass, elementwise, within 1e-5
    of max |S|), and its time (CUDA events, mean of 10 eager calls)."""
    import torch
    x, b, c, a = args
    states, totals = sk.chunk_states_cuda(x, b, a)
    ref_states, ref_totals = sref.chunk_states_ref(x, b, a)
    errs = {"chunk_states": ssd_check("ssd_scan chunk_states", states,
                                      ref_states)[0]}
    want = sref.state_pass_ref(states, totals)
    starts = sk.state_pass_cuda(states.clone(), totals)
    diff = float((starts - want).abs().max())
    if not diff <= 1e-5 * float(want.abs().max()):
        raise AssertionError(f"ssd_scan state_pass: max abs err {diff:.3g} "
                             "against the plain version")
    errs["state_pass"] = diff
    y = sk.chunk_scan_cuda(x, b, c, a, want)
    errs["chunk_scan"] = ssd_check("ssd_scan chunk_scan", y,
                                   sref.chunk_scan_ref(x, b, c, a, want))[0]
    torch.cuda.synchronize()
    scratch = states.clone()
    ms = {"chunk_states": time_ms(lambda: sk.chunk_states_cuda(x, b, a), 10),
          "state_pass": time_ms(lambda: sk.state_pass_cuda(scratch, totals),
                                10),
          "chunk_scan": time_ms(lambda: sk.chunk_scan_cuda(x, b, c, a, want,
                                                           out=y), 10)}
    print("ssd_scan stages: " + "; ".join(
        f"{k} {ms[k]:.4f} ms, max abs err {errs[k]:.3g} vs plain"
        for k in ms))
    return ms


def mamba_gate(cfg, dev, seed: int, P: int = 512) -> None:
    """The Mamba2 gate at full width on ``seed``'s weights and P-token
    prompt: ``forward`` with the kernel against the token-by-token
    ``decode_step`` recurrence at every position (the chunked dual form
    against the O(1) recurrence: independent computations), ``prefill``
    against the last decode step, and ``forward`` with the kernel against
    ``forward`` with the plain chunked form, each as max |diff| / max
    |logit| within ``MAMBA_GATE_TOL``.  Also printed: the plain form
    against the recurrence (the model's own rounding, no kernel in it)."""
    import torch
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, P))
                              .astype(np.int64)).to(dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    caches = M.init_cache(cfg, 1, P, device=dev)
    steps = []
    for i in range(P):
        out, caches = M.decode_step(params, cfg, prompt[:, i:i + 1], i,
                                    caches)
        steps.append(out[:, 0])
    rec = torch.cat(steps)                                   # (P, V)
    full = M.forward(params, cfg, tokens=prompt)[0][0]
    plain = M.forward(params, cfg, tokens=prompt, use_kernels=False)[0][0]
    last = M.prefill(params, cfg, tokens=prompt)[0]
    del params, caches
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    r = dict(recurrence=rel(full, rec), prefill=rel(last, rec[-1]),
             plain=rel(full, plain), floor=rel(plain, rec))
    tol = MAMBA_GATE_TOL[cfg.dtype]
    tag = f"{'bf16' if cfg.dtype == 'bfloat16' else 'f32'} seed {seed}"
    print(f"mamba: {P}-token prompt, {tag} {cfg.num_layers} layers: max "
          f"|diff| / max |logit| of forward (ssd_scan) vs the decode "
          f"recurrence {r['recurrence']:.4g} over all {P} positions (gate "
          f"{tol['recurrence']:g}), prefill vs last decode step "
          f"{r['prefill']:.4g} (gate {tol['prefill']:g}), forward vs the "
          f"plain chunked form {r['plain']:.4g} (gate {tol['plain']:g}); the "
          f"plain form vs the recurrence {r['floor']:.4g}")
    failed = [k for k, limit in tol.items() if not r[k] <= limit]
    if failed:
        raise AssertionError(f"mamba: {tag} gate failed: {failed}")


def mamba_path(dev, seed: int, counters, reset_counters) -> dict:
    """The Mamba2 path at mamba2-130m's full width: the gates, then 8
    requests through the serving engine and one prefill at B = 4,
    S = 8192; returns the kernels' launches in the path's run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import model as M

    cfg = get_config("mamba2-130m")
    for dtype in ("float32", "bfloat16"):
        for s in range(seed, seed + MAMBA_GATE_SEEDS):
            mamba_gate(cfg.with_(dtype=dtype), dev, s)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    n_params = sum(x.numel() for layer in params["layers"]
                   for part in layer.values() for x in part.values()) \
        + params["embed"]["w"].numel()
    print(f"mamba: mamba2-130m {cfg.num_layers} layers d_model {cfg.d_model} "
          f"ssm_state {cfg.ssm_state} heads {cfg.ssm_heads} x "
          f"{cfg.ssm_head_dim} vocab {cfg.vocab_size} {cfg.dtype}: "
          f"{n_params / 1e6:.1f} M parameters (tied head)")

    rng = np.random.default_rng(seed)
    engine, decode_s = timed_engine(cfg, params, dev)
    reqs = serve_requests(rng, cfg.vocab_size)
    frac = sum(r.tokens_needed for r in reqs) / 2048
    # cut from PREFILL_32K (32 x 32768) for the run's time
    long_prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (4, 8192)).astype(np.int64)).to(dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.submit(reqs)
    done = engine.run(max_steps=20_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefill_wall_ms, out = wall_ms(lambda: M.prefill(params, cfg,
                                                     tokens=long_prompt))
    launches = {n: c.count for n, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ticks = len(engine.stats["queue_len"])
    calls = len(decode_s)
    check_served("mamba", cfg, engine, done)
    expected = sk.LAUNCHES_PER_CALL * cfg.num_layers
    if launches["ssd_scan"] != expected or any(
            c for n, c in launches.items() if n != "ssd_scan"):
        raise AssertionError(f"mamba: launches {launches}, expected "
                             f"{expected} ssd_scan ({sk.LAUNCHES_PER_CALL} "
                             f"a layer) for the prefill, none per decode "
                             f"step, no other kernel")
    if out.shape != (4, cfg.vocab_size) or not bool(torch.isfinite(out)
                                                   .all()):
        raise AssertionError("mamba: prefill logits bad shape or values")
    generated = sum(len(r.out) for r in done)
    processed = sum(r.pos for r in done)
    prefill_ms = time_ms(lambda: M.prefill(params, cfg, tokens=long_prompt),
                         3)
    print(f"mamba path: 8 requests, KV demand {frac:.3f} replicas of 2, max "
          f"queue {max(engine.stats['queue_len'])}, admitted "
          f"{engine.stats['admitted']}, slot rejections "
          f"{engine.stats['rejected_slots']}; {ticks} ticks, {calls} replica "
          f"decode steps in {wall:.2f} s; generated {generated} tokens "
          f"({generated / wall:.1f} tokens/s), processed {processed} tokens "
          f"({processed / wall:.1f} tokens/s); decode step "
          f"{np.mean(decode_s) * 1e3:.2f} ms mean per replica tick (host "
          f"clock, synchronised); prefill B=4 S=8192 (cut from 32 x 32768) "
          f"{prefill_wall_ms:.1f} ms in the path, {prefill_ms:.1f} ms (CUDA "
          f"events, mean of 3); device memory peak {peak_gb:.2f} GB; "
          f"launches ssd_scan {launches['ssd_scan']} ({sk.LAUNCHES_PER_CALL} "
          f"a layer, 0 per decode step)")
    del engine
    profile_prefill(cfg, params, dev, long_prompt)
    profile_decode_step(cfg, params, dev, tag="mamba")
    del params
    torch.cuda.empty_cache()
    return launches


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
    from repro_torch.kernels.best_fit.ops import best_fit, best_fit_batched
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
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    warnings.simplefilter("error", GracefulDegradationWarning)
    counters = {"best_fit": bf_kernel.launches,
                "bfjs": bfjs_kernel.launches,
                "bfjs_mr": bfjs_mr_kernel.launches,
                "vqs": vqs_kernel.launches,
                "vqs_bf": vqs_bf_kernel.launches,
                "decode_attention": da.launches,
                "flash_attention": fa.launches,
                "ssd_scan": sk.launches}

    def reset_counters():
        for c in counters.values():
            c.reset()

    clock = PhaseClock()
    dev = torch.device("cuda")
    card = gpu_name_and_power_limit()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    clock.done("0 set-up and build")

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
    # the single-problem entry point, ops.best_fit, on one more draw of the law
    r1 = torch.from_numpy(rng.uniform(0, 1, L).astype(np.float32)).to(dev)
    s1 = torch.from_numpy(rng.uniform(0.01, 0.3, N).astype(np.float32)).to(dev)
    got1 = best_fit(r1, s1)
    torch.cuda.synchronize()
    require_equal("best_fit G=1", got1, tuple(
        x[0] for x in best_fit_ref_batched(r1[None], s1[None])))
    bf_g1_ms = time_ms(lambda: best_fit(r1, s1), reps=5)
    print(f"best_fit G={G} L={L} N={N}: equal to plain (exact); "
          f"{placed} of {G * N} placed; kernel {bf_ms:.3f} ms, plain "
          f"{bf_plain_ms:.1f} ms, bound {bf_bound:.4f} ms ({bf_by}); "
          f"G=1 (ops.best_fit): equal to plain, kernel {bf_g1_ms:.3f} ms")
    clock.done("1 best_fit kernel")

    # -- 2. bfjs kernel vs plain, bench shape and full width ---------------
    # (the bench shape's horizon cut from 2000 to BENCH_SLOTS, as in 3 and
    # 3b: the plain versions are bound by host launches a slot)
    for tag, (Gc, Lc, Kc, Qc, Ac, Tc, lam, mu, lo, hi) in {
            "bench": (8, 16, 24, 512, 8, BENCH_SLOTS, 1.5, 0.01, 0.05, 0.5),
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
    clock.done("2 bfjs kernel")

    # -- 3. vqs and vqs_bf kernels vs plain at the bench shape -------------
    # (benchmarks/sched_micro.py's VQS ensemble config, its 2000 slots cut
    # to BENCH_SLOTS; Qcap = 8192 puts the rings in the global workspace)
    Gb, Lb, Kb, Qb, Ab, Tb, Jb = 8, 16, 24, 8192, 8, BENCH_SLOTS, 4
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
    clock.done("3 vqs and vqs_bf kernels")

    # -- 3b. bfjs_mr kernel vs plain at the bench shape ---------------------
    # (benchmarks/sched_micro.py's _bench_mr_engines config on 4 members,
    # its 3000 slots cut to 1.5 x BENCH_SLOTS: the anti-correlated law,
    # where alignment packing differs most from the max-collapse)
    Gb, Lb, Kb, Qb, Ab, Tb = 4, 16, 16, 512, 8, 3 * BENCH_SLOTS // 2
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
    clock.done("3b bfjs_mr kernel")

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
    g, Tp = PLAIN_MEMBERS, PLAIN_SLOTS
    sub = (st.n[:g, :Tp], st.sizes[:g, :Tp], st.durs[:g, :Tp])
    sub_got = bfjs_kernel.bfjs_cuda(*sub, **kw)
    bfjs_plain_ms, ref = wall_ms(lambda: bfjs_ref(*sub, **kw))
    require_equal(f"bfjs path, first {g} members x {Tp} slots", sub_got,
                  ref)
    bfjs_bound, bfjs_by = bound(*bfjs_work(st, got, Lm, Km, Qm, Am))
    print(f"bfjs path shapes: equal to monte_carlo_policy on all {Gm} "
          f"members and to plain on members 0..{g - 1} x {Tp} slots "
          f"(exact); streams {streams_ms:.1f} ms, kernel {bfjs_ms:.1f} ms "
          f"({Gm} members), plain {bfjs_plain_ms:.1f} ms ({g} members x "
          f"{Tp} slots), bound {bfjs_bound:.4f} ms ({bfjs_by})")
    rows["bfjs"] = dict(
        name="bfjs", route="cuda",
        source="src/repro_torch/kernels/csrc/bfjs.cu",
        replaces="src/repro/kernels/bfjs/bfjs.py:37",
        launches=bfjs_launches, max_abs_err=max_abs_err(sub_got, ref),
        ms=bfjs_ms, plain_ms=bfjs_plain_ms, bound_ms=bfjs_bound,
        bound_by=bfjs_by, library_ms=None, plain_members=g, plain_slots=Tp)
    del st, got, ref, res, sub, sub_got
    clock.done("4 bfjs path")

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
        g, Tp = PLAIN_MEMBERS, PLAIN_SLOTS
        sub = (st.n[:g, :Tp], st.sizes[:g, :Tp], st.durs[:g, :Tp])
        sub_got = fn(*sub, **kw)
        plain_ms, ref = wall_ms(lambda: plain(*sub, **kw))
        require_equal(f"{policy} path, first {g} members x {Tp} slots",
                      sub_got, ref)
        sub_ms = time_ms(lambda: fn(*sub, **kw), reps=3)
        b_ms, b_by = bound(*vqs_work(st, got, Lm, Jv, name == "vqs_bf"))
        shape = (Jv, Lm, Km, Qv, Am)
        ws = getattr(vqs_kernel.load(name), f"{name}_workspace_bytes")
        print(f"{policy} path shapes: equal to plain on members 0..{g - 1} "
              f"x {Tp} slots (exact); streams {streams_ms:.1f} ms, kernel "
              f"{ms:.1f} ms ({Gm} members) / {sub_ms:.1f} ms ({g} members x "
              f"{Tp} slots), plain {plain_ms:.1f} ms ({g} members x {Tp} "
              f"slots), bound {b_ms:.4f} ms ({b_by}); shared memory "
              f"{vqs_kernel.shared_bytes(name, *shape)} B a block, "
              f"workspace {ws(*shape)} B a member")
        rows[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=max_abs_err(sub_got, ref), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, plain_members=g, plain_slots=Tp)
        del st, got, ref, res, sub, sub_got
    clock.done("5 vqs and vqs-bf paths")

    # -- 5b. vqs-bf where it queues: offered load 0.8, so the ring pops of
    # step (iii) are timed (VQS-BF is proven to 2/3 of the load, so drops
    # here are a reading, not a failure)
    lam_q = 0.8 * Lm * mu / size_mean          # lam = 16
    st = ensemble_streams(seeds, lam_q, mu, uniform(0.1, 0.9), L=Lm, K=Km,
                          A_max=Am, horizon=Tm, device=dev)
    kw = dict(J=Jv, L=Lm, K=Km, Qcap=Qv, A_max=Am, work_steps=Am + 4)
    got = vqs_bf_kernel.vqs_bf_cuda(st.n, st.sizes, st.durs, **kw)
    mean_q = float(got.queue_len.double().mean())
    if not mean_q > 0:
        raise AssertionError("vqs-bf at load 0.8: the queue never filled, "
                             "so no ring pop was timed")
    ms = time_ms(lambda: vqs_bf_kernel.vqs_bf_cuda(st.n, st.sizes, st.durs,
                                                   **kw), reps=3)
    g, Tq = 2, 200
    sub = (st.n[:g, :Tq], st.sizes[:g, :Tq], st.durs[:g, :Tq])
    sub_got = vqs_bf_kernel.vqs_bf_cuda(*sub, **kw)
    require_equal(f"vqs-bf at load 0.8, first {g} members x {Tq} slots",
                  sub_got, vqs_bf_ref(*sub, **kw))
    print(f"vqs-bf queueing G={Gm} J={Jv} L={Lm} K={Km} Qcap={Qv} "
          f"A_max={Am} T={Tm} lam={lam_q}: kernel {ms:.1f} ms; mean queue "
          f"{mean_q:.3f}; dropped {int(got.dropped.sum())}; truncated "
          f"{int(got.truncated.sum())}; equal to plain on members "
          f"0..{g - 1} x {Tq} slots (exact)")
    rows["vqs_bf"]["ms_at_load_0_8"] = ms
    del got, sub, sub_got
    clock.done("5b vqs-bf at load 0.8")

    # -- 5c. vqs where it queues: the same streams at offered load 0.8, so
    # the walk over the pending servers and the packing bursts from deep
    # rings are timed (drops here are a reading, not a failure)
    kw = dict(J=Jv, L=Lm, K=Km, Qcap=Qv, A_max=Am, work_steps=Am + 4,
              drain=16)
    got = vqs_kernel.vqs_cuda(st.n, st.sizes, st.durs, **kw)
    mean_q = float(got.queue_len.double().mean())
    if not mean_q > 0:
        raise AssertionError("vqs at load 0.8: the queue never filled, so no "
                             "packing burst was timed")
    ms = time_ms(lambda: vqs_kernel.vqs_cuda(st.n, st.sizes, st.durs, **kw),
                 reps=3)
    sub = (st.n[:g, :Tq], st.sizes[:g, :Tq], st.durs[:g, :Tq])
    sub_got = vqs_kernel.vqs_cuda(*sub, **kw)
    require_equal(f"vqs at load 0.8, first {g} members x {Tq} slots",
                  sub_got, vqs_ref(*sub, **kw))
    print(f"vqs queueing G={Gm} J={Jv} L={Lm} K={Km} Qcap={Qv} A_max={Am} "
          f"T={Tm} lam={lam_q}: kernel {ms:.1f} ms; mean queue "
          f"{mean_q:.3f}; dropped {int(got.dropped.sum())}; truncated "
          f"{int(got.truncated.sum())}; equal to plain on members "
          f"0..{g - 1} x {Tq} slots (exact)")
    rows["vqs"]["ms_at_load_0_8"] = ms
    del st, got, sub, sub_got
    clock.done("5c vqs at load 0.8")

    # -- 5d. the oracle bridge: the vqs and vqs-bf paths on one trace at full
    # width, held to the event-driven simulate_trace slot for slot
    bridge_phase(dev, args.seed, counters, reset_counters, L=Lm, T=Tm,
                 lam=lam_q, mu=mu)
    clock.done("5d oracle bridge")

    # -- 5e. the trace path: the paper's Google-trace experiment through the
    # vqs, vqs-bf and bfjs-mr kernels, held to the host oracles; the four
    # policies' "cuda" and "reference" engines on card-made streams
    trace_phase(dev, args.seed, counters, reset_counters, card)
    clock.done("5e trace path")

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
    g, Tp = PLAIN_MEMBERS, PLAIN_SLOTS
    sub = (st.n[:g, :Tp], st.sizes[:g, :Tp], st.durs[:g, :Tp])
    sub_got = bfjs_mr_kernel.bfjs_mr_cuda(*sub, **kw)
    plain_ms, ref = wall_ms(lambda: bfjs_mr_ref(*sub, **kw))
    require_equal(f"bfjs-mr path, first {g} members x {Tp} slots", sub_got,
                  ref)
    sub_ms = time_ms(lambda: bfjs_mr_kernel.bfjs_mr_cuda(*sub, **kw),
                     reps=3)
    b_ms, b_by = bound(*mr_work(st, got, Lm))
    shape = (Lm, Km, Qr, Am, Rm)
    lib = bfjs_mr_kernel.load()
    print(f"bfjs-mr path shapes: equal to plain on members 0..{g - 1} x "
          f"{Tp} slots (exact, truncated {int(ref.truncated.sum())} in "
          f"both); streams {streams_ms:.1f} ms, kernel {ms:.1f} ms ({Gm} "
          f"members) / {sub_ms:.1f} ms ({g} members x {Tp} slots), plain "
          f"{plain_ms:.1f} ms ({g} members x {Tp} slots), bound "
          f"{b_ms:.4f} ms ({b_by}); shared memory "
          f"{lib.bfjs_mr_shared_bytes(*shape)} B a block, workspace "
          f"{lib.bfjs_mr_workspace_bytes(*shape)} B a member")
    rows["bfjs_mr"] = dict(
        name="bfjs_mr", route="cuda",
        source="src/repro_torch/kernels/csrc/bfjs_mr.cu",
        replaces="src/repro/kernels/bfjs_mr/bfjs_mr.py:46",
        launches=mr_launches, max_abs_err=max_abs_err(sub_got, ref),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, plain_members=g, plain_slots=Tp)
    del st, got, ref, res, sub, sub_got
    clock.done("6 bfjs-mr path")

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
        library_ms=None, ms_g1=bf_g1_ms)
    clock.done("7 best-fit path")

    # -- 8. attention kernels vs plain at the serve path's shapes -----------
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:22",
        **decode_phase(dev, args.seed))
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:21",
        **flash_phase(dev, args.seed))
    clock.done("8 attention kernels")

    # -- 9. serve path: llama3-8b at full width --------------------------------
    launches = serve_path(dev, args.seed, counters, reset_counters)
    for name in ("decode_attention", "flash_attention"):
        rows[name]["launches"] = launches[name]
    clock.done("9 serve path")

    # -- 10. ssd_scan kernel vs plain at the Mamba2 prefill shape -------------
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:22",
        **ssd_phase(dev, args.seed))
    clock.done("10 ssd_scan kernel")

    # -- 11. Mamba2 path: mamba2-130m at full width -----------------------------
    launches = mamba_path(dev, args.seed, counters, reset_counters)
    rows["ssd_scan"]["launches"] = launches["ssd_scan"]
    clock.done("11 mamba path")

    print(f"chip_smoke: all phases passed in {clock.total():.1f} s")
    order = ("bfjs", "vqs", "vqs_bf", "bfjs_mr", "best_fit",
             "decode_attention", "flash_attention", "ssd_scan")
    print(json.dumps({"kernels": [rows[k] for k in order], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
