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
  * serve path: llama3-8b at full width (d_model 4096, vocab 128256,
    bf16, random weights from ``--seed``), depth cut to ``SERVE_LAYERS``
    = 16 of 32 for the engine run, the prefill and the profile, behind
    ``ServingEngine(num_replicas=2, b_slots=4, c_max=2048, policy="bf")``
    answering 8 requests (prompts U[256, 1024] tokens, U[16, 64] new
    tokens, submitted at once, so the BF-J/S admission queue fills), then
    one ``prefill`` of 2048 tokens: the decode_attention kernel on every
    decode step, the flash_attention kernel on prefill.  Teacher-forced
    gates hold the model's decode with the kernels against decode with
    their plain versions, and prefill against the last decode step, in
    bf16 (before the path, on the weights and prompts of two seeds) and
    in float32 on the prompt's first 64 tokens (after it), both at all 32
    layers.  A profile of one full-width decode step then splits its
    device time by kernel and gives the card's busy share;
  * Mamba2 path: the ssd_scan kernel against its plain version (the
    sequential recurrence) at the prefill shape below and the shapes of
    tests/test_kernels.py, then mamba2-130m at full width (24 layers,
    d_model 768, state 128, 24 heads of 64, vocab 50280, bf16, random
    weights from ``--seed``): gates holding ``forward`` / ``prefill``
    with the kernel against the token-by-token ``decode_step`` recurrence
    over every position of a 512-token prompt (two chunks) and against
    the plain chunked form, in float32 (the gate that decides) and in
    bf16, on two seeds each; then the same engine and 8-request traffic
    as the serve path, and one ``prefill`` at B = 4, S = 8192 (cut from
    32 x 32768): ssd_scan's three stage kernels on every prefill layer,
    no kernel on decode.  Profiles of the prefill (by kernel, then by
    operator and call site) and of one decode step follow;
  * chunked, streaming and supervised paths (phase 12, ``runtime_phase``)
    at the bfjs and vqs paths' width (L = 1000, K = 16, A_max = 48, Qcap
    = 4096) on the first ``PLAIN_MEMBERS`` x ``PLAIN_SLOTS`` of card-made
    streams: a ``run_policy_streams(chunk=50, checkpoint_dir=...)`` bfjs
    sweep at load 1.6 (a queue in its carry by the second checkpoint)
    SIGKILLed in a child process after that checkpoint and resumed, equal
    to one bfjs kernel launch; a vqs
    ``stream_policy`` at load 0.8 staged from host chunks, its third
    checkpoint truncated, resumed under a ``Supervisor`` with the audit
    over a source with planted ingestion faults (one rollback, the planted
    retries), equal to one vqs kernel launch; ``stream_policy(engine=
    "cuda")`` refused with a ValueError and no launch; the audited
    ``"cuda"`` bfjs path at load 0.85 on all 128 members x 1000 slots
    passing and a tampered occupancy failing;
  * fleet runtime (phase 13): ``monte_carlo_policy(engine="cuda",
    devices=[card, card])`` (``devices=torch.cuda.device_count()`` on a
    machine with more cards) on the bfjs, vqs, vqs-bf and bfjs-mr paths at
    full width, equal to the unsharded launch, one launch a shard; a chunked
    bfjs sweep at load 1.6 checkpointed on 2 shards and resumed on 1, equal
    to the bfjs kernel; ``autotune(engine="cuda")`` on the vqs path into a
    throwaway cache, its verified winner found again by
    ``monte_carlo_policy``; ``estimate_capacity`` on 1000 replicas at load
    0.85, unsharded and sharded alike, and 500 replicas saturating; the
    live admission kernel against its plain version on random op
    sequences; and, on the serve path's weights (so inside phase 9),
    llama3-8b behind ``ServingEngine(admission="live")`` and ``"host"``
    (one replica of 3 slots, 12 requests that fill the queue and meet full
    slots), equal placements, tokens and stats, one admission launch a
    controller call;
  * MLA, MoE and the sliding-window ring (phase 14): deepseek-v2-lite-16b
    at full width (27 layers, d_model 2048, MLA with kv_lora_rank 512 and
    q/k 192 and v 128 wide, 64 routed experts top-6 and 2 shared, vocab
    102400, bf16, random weights from ``--seed``; 16.2 B parameters):
    teacher-forced gates over 128 tokens of decode and prefill with the
    kernels against their plain versions, in bf16 (the kernel run on the
    plain run's expert picks, ``PinnedRouting``) and in float32 at 4
    layers (which decides), then ``timed_engine`` with 10 short requests
    and one 2048-token ``prefill``: decode_attention on every tick (H =
    KV = 16), flash_attention on the prefill, nothing else.
    h2o-danube-3-4b at full width (24 layers, GQA 32/8, hd 120, window
    4096): every layer's ring (C = 4096) filled with random bf16 values
    from the seed, one ``decode_step`` of rows at positions 4095, 4096,
    6000 and 12287 (before, at and past the wrap) with the kernels and
    plain, in float32 and in bf16, each float32 plain layer held to the
    linear 12288-slot cache through the window mask; a serve with c_max
    8192 and one 8192-token prefill.  Then both attention kernels at these
    shapes against their plain versions, with device, bound and SDPA
    times;
  * training on one device (phase 15): the tensor-core instructions of
    the flash backward's tensor-core instances, then at ``BWD_SHAPES``
    (llama3-8b's microbatch in bf16 and float32, the 10M model, danube's
    window, MLA's widths) the forward kernel's saved log-sum-exp against
    ``attention_lse_ref`` (``LSE_TOL``) and the backward kernel
    (``csrc/flash_attention_bwd.cu``) fed it against its plain version
    (``attention_bwd_ref``, float32), two calls equal bit for bit, each
    shape naming its instance, timed beside SDPA's backward alone and its
    forward and backward (15a); llama3-8b at full width (d_model 4096,
    32/8 heads, d_ff 14336, vocab 128256), depth cut to ``TRAIN_LAYERS`` =
    4 of 32,
    float32 masters from ``--seed`` and bf16 compute: the gradients
    through the kernels held per parameter to the plain attention's on
    the same card in bf16 and float32, ``Trainer.run`` for 4 steps of 2
    microbatches x 2 x 2048 tokens with every loss finite and exact
    launch counts (per layer and microbatch a flash forward, its remat
    re-run and two backward launches), a profile of one step with the
    flash kernels' share, then the trained weights in bf16 served (15b);
    examples/train_small.py's 10M
    model trained 60 steps (the loss falls by 10%), and a run preempted
    at step 36 and resumed from its step-36 checkpoint equal to the
    uninterrupted one bit for bit, under deterministic algorithms (15c);
  * the chunk scan's backward (phase 16): the tensor-core instructions of
    its kernels (``csrc/ssd_scan_bwd.cu``), then at ``SSD_BWD_SHAPES``
    (mamba2-130m's training microbatch, 4 x 4096 tokens in chunks of 256,
    as ``mamba_apply`` gives it and all float32; two groups of ragged
    widths; Lc = 1024) the gradients through ``SSDScan`` held per tensor
    to the plain backward (``ssd_bwd_ref``) and to autograd of the chunked
    form in float64 (``SSD_BWD_TOL``), two calls equal bit for bit, each
    stage kernel against its plain stage, timed beside the bound (16a);
    mamba2-130m at full width and depth (24 layers), float32 masters from
    ``--seed`` and bf16 compute: the gradients through the kernels held
    per parameter to the plain chunked form's in bf16 and float32
    (``MAMBA_TRAIN_GRAD_TOL``), ``Trainer.run`` for 4 steps of 2
    microbatches x 4 x 4096 tokens (global batch 8, cut from TRAIN_4K's
    256) with every loss finite and exact launch counts (per layer and
    microbatch the scan's three forward launches, their remat re-run and
    four backward launches), a profile of one step with the scan's
    forward, re-run and backward apart, then the trained weights in bf16
    served (16b); jamba-1.5-large-398b's smoke config (attention, MoE and
    Mamba with two groups) trained 2 steps in float32 behind the same
    gate (16c).

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
with one entry per kernel, eleven, live_admission last (launches, error
against the plain version, kernel, plain, bound and library times; the attention
kernels' and SDPA's times are device times of a CUDA graph of calls, since
an eager decode call is bound by the host; best_fit's row adds ``ms_g1``,
the single-problem ``ops.best_fit`` at the same law; the bfjs and vqs rows
add ``launches_phase_12``, their launches on phase 12's paths; the
decode_attention and flash_attention rows add phase 14's shapes under
suffixed keys, ``ms_mla``, ``bound_ms_mla``, ``library_ms_mla`` and the
rest for MLA's widths, ``_ring`` for the wrapped ring decode, ``_swa``
for the windowed 8192-token prefill, and ``launches_phase_14a`` /
``launches_phase_14b``; flash_attention_bwd's row is llama's bf16
microbatch, the other 15a shapes under suffixed keys such as
``ms_llama_float32`` and ``ms_swa_bfloat16``, and its launches are
15b's, 15c's under ``launches_phase_15c``; ssd_scan_bwd's row is 16a's
"train" shape with each stage's time and each gradient's readings, the
other shapes under suffixed keys such as ``ms_float32``, and its
launches are 16b's, 16c's under ``launches_phase_16c``; the ssd_scan row
adds its launches in 16b and 16c); the last line is
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

#: Layers of llama3-8b that phase 9's engine run, its 2048-token prefill,
#: the decode-step profile and phase 13e's serve run on: cut from 32 for
#: the script's time (the serve path is host-bound, ~57 launches a layer
#: a decode step); the teacher-forced gates keep all 32.
SERVE_LAYERS = 16

#: Seeds whose weights and 256-token prompt the bf16 teacher-forced gate
#: runs on: ``--seed`` and the one after it.  Cut from 3 when phase 14
#: took the script past 950 s on a slow host (its limits rest on seeds
#: 0-5: ``GATE_TOL``).
BF16_GATE_SEEDS = 2

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
#: Together they fit the phase's 150 s on a slow host.  (20,000 slots of
#: vqs-bf took 45.3 s, 40,000 37.3-40.4 s: most of its cost is early.)
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

#: Limits of the bf16 attention checks: the largest over the queries of
#: max |diff| / max |out| within the query's output, the kernel's output
#: against the plain version's float32 output (unrounded, so the check
#: sees the kernel's error and not two roundings to bf16; ``rel_errs``).
#: ``attn_check``'s absolute limit cannot stand alone in bf16: an output
#: that averages 10^3 keys is about the limit's size.  Readings of
#: tools/attention_margins.py on every shape and window below, seeds 0-2
#: (PERF.md, section 6): sound decode 0.0030-0.0037, flash
#: 0.0039-0.0061; with the softmax scale off by 0.5%, decode 0.0113 and
#: more, flash 0.0203 and more (off by 1%: 0.0199 and 0.0370 and more).
BF16_REL_TOL = {"decode_attention": 7e-3, "flash_attention": 1e-2}

#: h2o-danube-3-4b's ring decode rows: before, at and past the ring's wrap
#: (C = window = 4096), up to 3 C.
RING_POSITIONS = (4095, 4096, 6000, 12287)

#: The bf16 shapes each attention kernel is held to its plain version and
#: timed at.  decode_attention: (B, H, KV, C, hd, hd_v, positions,
#: windows); flash_attention: (B, H, KV, S, hd, hd_v, windows), causal.
#: "serve" is llama3-8b's serve path (phase 8), "mla" deepseek-v2-lite-16b's
#: MLA (q and k 192 wide, v 128, KV = H), "ring" h2o-danube-3-4b's wrapped
#: ring (the model decodes it with window 0, models/attention.py) and
#: "swa" its windowed prefill (phase 14c).
DECODE_SHAPES = {
    "serve": (4, 32, 8, 2048, 128, 128, (0, 511, 1337, 2047), (0, 512)),
    "mla": (4, 16, 16, 2048, 192, 128, (0, 700, 1500, 2047), (0,)),
    "ring": (4, 32, 8, 4096, 120, 120, RING_POSITIONS, (0,))}
FLASH_SHAPES = {
    "serve": (1, 32, 8, 2048, 128, 128, (0, 512)),
    "mla": (1, 16, 16, 2048, 192, 128, (0,)),
    "swa": (1, 32, 8, 8192, 120, 120, (4096,))}

#: Calls a time is the mean of: (kernel and SDPA in a CUDA graph, the plain
#: version on CUDA events).
ATTN_REPS = {"decode_attention": (50, 5), "flash_attention": (10, 3)}

#: The sub-keys each shape gives a kernel's row.
ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


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


def rel_errs(got, ref) -> tuple[float, float]:
    """Against ``ref``, in float64: the largest over the queries of max
    |diff| / max |ref| within the query's output (the checks' reading),
    and max |diff| / max |ref| over the whole tensor.  The first sees every
    query alike; the second, only those of few keys, whose outputs are
    largest."""
    a, b = (x.double().reshape(-1, x.shape[-1]) for x in (got, ref))
    d = (a - b).abs()
    per_query = d.amax(-1) / b.abs().amax(-1).clamp_min(1e-30)
    return float(per_query.max()), float(d.max()) / float(b.abs().max())


def decode_valid_rows(pos, C: int, window: int) -> list[int]:
    """Valid cache rows per batch row for the decode mask."""
    return [min(p + 1, C, window) if window else min(p + 1, C) for p in pos]


def attention_inputs(dev, seed: int, kernel: str, tag: str) -> tuple:
    """bf16 inputs of ``kernel`` at shape ``tag``, standard normal from
    numpy's generator on (seed, kernel, shape): decode_attention's q (B, H,
    hd), k (B, KV, C, hd), v (B, KV, C, hd_v) and (B,) int32 positions;
    flash_attention's q, k, v as the model's (B, S, ., .) views transposed
    to (B, ., S, .)."""
    import torch
    shapes = DECODE_SHAPES if kernel == "decode_attention" else FLASH_SHAPES
    rng = np.random.default_rng([seed, int(kernel == "flash_attention"),
                                 list(shapes).index(tag)])

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=torch.bfloat16)
    if kernel == "decode_attention":
        B, H, KV, C, hd, hd_v, pos, _ = shapes[tag]
        return (normal(B, H, hd), normal(B, KV, C, hd),
                normal(B, KV, C, hd_v),
                torch.tensor(pos, dtype=torch.int32, device=dev))
    B, H, KV, S, hd, hd_v, _ = shapes[tag]
    return tuple(normal(B, S, n, d).transpose(1, 2)
                 for n, d in ((H, hd), (KV, hd), (KV, hd_v)))


def attention_calls(kernel: str, inputs, window: int) -> tuple:
    """Calls of no argument on ``inputs``: the kernel, its plain version,
    the plain version on float32 copies (unrounded), and one SDPA call of
    the same function (GQA through ``enable_gqa``; a boolean mask where
    ``is_causal`` cannot say it) with its description."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    if kernel == "decode_attention":
        q, k, v, p = inputs
        c_pos = torch.arange(k.shape[2], device=q.device)
        mask = c_pos[None] <= p[:, None].long()
        if window:
            mask &= c_pos[None] > p[:, None].long() - window
        qs, mask = q[:, :, None], mask[:, None, None]
        return (lambda: da.decode_attention_cuda(q, k, v, p, window=window),
                lambda: decode_attention_ref(q, k, v, p, window=window),
                lambda: decode_attention_ref(q.float(), k.float(), v.float(),
                                             p, window=window),
                lambda: F.scaled_dot_product_attention(
                    qs, k, v, attn_mask=mask, enable_gqa=True),
                "SDPA, boolean mask")
    q, k, v = inputs
    if window:
        i = torch.arange(q.shape[2], device=q.device)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
    else:
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    return (lambda: fa.flash_attention_cuda(q, k, v, causal=True,
                                            window=window),
            lambda: attention_ref(q, k, v, causal=True, window=window),
            lambda: attention_ref(q.float(), k.float(), v.float(),
                                  causal=True, window=window),
            lib, "SDPA, boolean window mask" if window else "SDPA is_causal")


def attention_work(kernel: str, inputs, window: int) -> tuple[int, int]:
    """The bytes a call must move (each input read once, each output
    written once; decode reads only the valid cache rows) and its products'
    operations over the (query, key) pairs the mask keeps, 2 (hd + hd_v) a
    pair and query head."""
    q, k, v = inputs[:3]
    B, H = q.shape[:2]
    KV, n = k.shape[1:3]
    hd, hd_v = q.shape[-1], v.shape[-1]
    if kernel == "decode_attention":
        rows = sum(decode_valid_rows(inputs[3].tolist(), n, window))
        nbytes = rows * KV * (hd + hd_v) + B * H * (hd + hd_v)
        pairs = rows
    else:
        nbytes = B * n * (H + KV) * (hd + hd_v)
        pairs = B * sum(min(i + 1, window) if window else i + 1
                        for i in range(n))
    return q.element_size() * nbytes, 2 * (hd + hd_v) * H * pairs


def attention_row(kernel: str, tag: str, inputs, window: int) -> dict:
    """Hold ``kernel`` to its plain version on bf16 ``inputs`` (within
    ``ATTN_TOL`` of the plain bf16 output and ``BF16_REL_TOL`` of its
    float32 output), then time the kernel and SDPA in device time
    (``device_ms``), the kernel's eager call and the plain version on CUDA
    events, and take the bound; prints one line and returns the row's
    ``ROW_KEYS``."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention as fa
    kern, plain, plain32, lib, lib_what = attention_calls(kernel, inputs,
                                                          window)
    what = f"{kernel} {tag} window={window}"
    got = kern()
    torch.cuda.synchronize()
    err = attn_check(what, got, plain())
    ref = plain32()
    rel, rel_all = rel_errs(got, ref)
    del got, ref
    if not rel <= BF16_REL_TOL[kernel]:
        raise AssertionError(f"{what}: max |diff| / max |out| of a query "
                             f"{rel:.4g} against the float32 plain output, "
                             f"over {BF16_REL_TOL[kernel]}")
    reps, plain_reps = ATTN_REPS[kernel]
    ms = device_ms(kern, reps)
    call_ms = time_ms(kern, reps)
    plain_ms = time_ms(plain, plain_reps)
    lib_ms = device_ms(lib, reps)
    nbytes, ops = attention_work(kernel, inputs, window)
    b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S)
    q, k, v = inputs[:3]
    B, H = q.shape[:2]
    KV, n = k.shape[1:3]
    hd, hd_v = q.shape[-1], v.shape[-1]
    if kernel == "decode_attention":
        shape = (f"B={B} H={H} KV={KV} C={n} hd={hd} hd_v={hd_v} pos="
                 f"{tuple(inputs[3].tolist())} (clusters of "
                 f"{da.cluster_size(B, H, KV, n)})")
    else:
        shape = (f"B={B} H={H} KV={KV} S={n} hd={hd} hd_v={hd_v} causal "
                 f"({fa.instance(q.dtype, hd)} instance)")
    print(f"{what} {shape} bf16: max abs err {err:.3g} vs plain (tol "
          f"{ATTN_TOL['bfloat16']:g}); against the float32 plain output max "
          f"|diff| / max |out| {rel:.4g} a query (limit "
          f"{BF16_REL_TOL[kernel]:g}), {rel_all:.4g} over the whole output; "
          f"kernel {ms:.4f} ms device "
          f"({call_ms:.4f} ms an eager call, {ops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, library ({lib_what}) {lib_ms:.4f} ms "
          f"device, bound {b_ms:.4f} ms ({b_by}, {nbytes:.4g} B, {ops:.4g} "
          f"operations at {BF16_TC_OPS_PER_S:.4g}/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def shape_row(kernel: str, tag: str, inputs) -> dict:
    """``attention_row`` at each window of shape ``tag``: the first
    window's row, with the largest abs error over the windows."""
    shapes = DECODE_SHAPES if kernel == "decode_attention" else FLASH_SHAPES
    rows = [attention_row(kernel, tag, inputs, w) for w in shapes[tag][-1]]
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def decode_phase(dev, seed: int) -> dict:
    """decode_attention kernel against its plain version at the serve
    path's shape (``DECODE_SHAPES["serve"]``, window 0 and 512) and the f32
    sweep of tests/test_kernels.py; the row's times at window 0."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, H, KV, C = DECODE_SHAPES["serve"][:4]
    cs = da.cluster_size(B, H, KV, C)
    units = B * KV * -(-(H // KV) // 4)
    print(f"decode_attention instance: clusters of {cs} blocks, one per "
          f"(row, kv head, group of 4 query heads): {units * cs} blocks, the "
          "split over the cache merged in the same launch")
    row = shape_row("decode_attention", "serve", attention_inputs(
        dev, seed, "decode_attention", "serve"))
    rng = np.random.default_rng(seed)
    for C32, pos32, w32 in ((256, 0, 0), (256, 255, 0), (512, 300, 128)):
        q32, k32, v32 = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev) for s in ((2, 8, 64), (2, 2, C32, 64),
                                           (2, 2, C32, 64)))
        got = da.decode_attention_cuda(q32, k32, v32, pos32, window=w32)
        torch.cuda.synchronize()
        err = attn_check(f"decode_attention f32 C={C32}", got,
                         decode_attention_ref(q32, k32, v32, pos32,
                                              window=w32))
        print(f"decode_attention B=2 H=8 KV=2 C={C32} hd=64 f32 pos={pos32} "
              f"window={w32}: max abs err {err:.3g} vs plain (tol 2e-5)")
    return row


def flash_phase(dev, seed: int) -> dict:
    """flash_attention kernel against its plain version at llama3-8b's
    prefill shape (``FLASH_SHAPES["serve"]``, causal, window 0 and 512),
    the output's strides, and the f32 sweep of tests/test_kernels.py; the
    row's times at window 0."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    inputs = attention_inputs(dev, seed, "flash_attention", "serve")
    q = inputs[0]
    print(f"flash_attention instance: {fa.instance(q.dtype, q.shape[-1])} "
          f"(bf16, hd={q.shape[-1]}), strided (B, S, H, hd) views in and "
          f"out")
    got = fa.flash_attention_cuda(*inputs, causal=True)
    torch.cuda.synchronize()
    if got.stride() != q.stride():
        raise AssertionError("flash_attention: the output does not keep "
                             "q's strides")
    del got
    row = shape_row("flash_attention", "serve", inputs)
    rng = np.random.default_rng(seed + 1)
    for S32, hd32, w32 in ((128, 64, 0), (256, 64, 0), (256, 128, 64)):
        q32, k32, v32 = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev) for s in ((2, 4, S32, hd32),
                                           (2, 2, S32, hd32),
                                           (2, 2, S32, hd32)))
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
                 unit: str, parts: dict | None = None,
                 ranges: tuple = ()) -> None:
    """Print the device time of ``reps`` runs of one ``unit`` recorded by
    ``prof`` in a ``wall_us`` window: the busy share, the time per run,
    the matrix products' share, each of ``parts`` (a label and the
    substrings of its kernels' names), the device time under each of the
    ``record_function`` ``ranges`` (the profiler lists them among the
    device's entries; they are kept out of the kernels' sums) and the ten
    largest kernels."""
    import torch
    times: dict[str, float] = {}
    marked: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key in ranges:
            marked[e.key] = e.device_time_total
            continue
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
    for label, keys in (parts or {}).items():
        us = sum(t for name, t in times.items()
                 if any(k in name for k in keys))
        print(f"{tag} profile: {label} {us / reps / 1e3:.3f} ms/{unit} "
              f"({us / busy:.1%})")
    for name in ranges:
        us = marked.get(name, 0.0)
        print(f"{tag} profile: under {name!r} "
              + (f"{us / reps / 1e3:.3f} ms/{unit} ({us / busy:.1%})" if us
                 else "no device time recorded: not measured"))
    for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:10]:
        print(f"{tag} profile:  {us / reps / 1e3:8.3f} ms/{unit} "
              f"{us / busy:6.1%}  {name[:90]}")


def timed_engine(cfg, params, dev, num_replicas: int = 2,
                 c_max: int = 2048):
    """The serve paths' engine, ``ServingEngine(num_replicas, b_slots=4,
    c_max, policy="bf", audit=True)``, with each replica's decode timed on
    the host clock (it ends in the greedy tokens' copy to the host);
    returns the engine and the list the times go to."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(cfg, params, num_replicas=num_replicas,
                           b_slots=4, c_max=c_max, policy="bf", audit=True,
                           device=dev)
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


def check_served(tag: str, cfg, engine, done, n: int = 8) -> None:
    """Every one of the ``n`` requests completed with its tokens, in the
    vocabulary, and the admission queue filled."""
    if len(done) != n or any(len(r.out) != r.max_new for r in done):
        raise AssertionError(f"{tag}: not every request completed with its "
                             "max_new tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        raise AssertionError(f"{tag}: a generated token is out of the vocab")
    if not max(engine.stats["queue_len"]) > 0:
        raise AssertionError(f"{tag}: the admission queue never filled")


def serve_path(dev, seed: int, counters, reset_counters,
               with_weights=None) -> dict:
    """The LM serving path at llama3-8b's full width, the gates at full
    depth and the path at ``SERVE_LAYERS``; returns the two attention
    kernels' launches in the path's run.  ``with_weights(cfg, params)``
    runs on the path's bf16 weights before they are freed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("llama3-8b")

    # -- teacher-forced gates (GATE_TOL): kernels vs plain versions, prefill
    # vs decode; the float32 one follows the path
    for s in range(seed, seed + BF16_GATE_SEEDS):
        gate_on_seed(cfg, dev, s, 256)
    full, cfg = cfg, cfg.with_(num_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    init_ms, params = wall_ms(lambda: M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    n_params = sum(x.numel() for x in [params["embed"]["w"],
                                       params["head"]["w"]]) + sum(
        x.numel() for layer in params["layers"]
        for part in layer.values() for x in part.values())
    print(f"serve: llama3-8b {cfg.num_layers} of {full.num_layers} layers "
          f"d_model {cfg.d_model} "
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
    if with_weights is not None:
        with_weights(cfg, params)
    del params
    torch.cuda.empty_cache()

    # the same gates in float32 at full width and depth, on the prompt's
    # first 64 tokens: here the kernels and the model must agree to float32
    # precision, not to bf16's
    gate_on_seed(full.with_(dtype="float32"), dev, seed, 64)
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
#: Seeds each dtype's Mamba2 gate runs on: ``--seed`` and the one after
#: it, cut from 3 as ``BF16_GATE_SEEDS`` was.
MAMBA_GATE_SEEDS = 2


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


#: Slots a chunk of the phase-12 sweeps and streams: 250 slots in five
#: checkpointed boundaries.
RUNTIME_CHUNK = 50

#: The SIGKILL child of phase 12a: a bfjs sweep of the streams in argv[2]
#: (an .npz) on device argv[4] with config argv[3] (JSON), chunked at
#: argv[5] slots with checkpoints in argv[1], killed from inside the
#: checkpoint writer right after save 2 (no cleanup, no atexit).
KILLED_SWEEP = r"""
import json, os, signal, sys
import numpy as np
import repro_torch.core.engine.chunked as chunked
from repro_torch.convert import streams_from_numpy
from repro_torch.core.engine import run_policy_streams

planes = np.load(sys.argv[2])
streams = streams_from_numpy(planes["n"], planes["sizes"], planes["durs"],
                             device=sys.argv[4])
real, saves = chunked._save_step, [0]


def killing_save(*args, **kwargs):
    real(*args, **kwargs)
    saves[0] += 1
    if saves[0] == 2:
        os.kill(os.getpid(), signal.SIGKILL)


chunked._save_step = killing_save
run_policy_streams(streams, policy="bfjs", engine="scan",
                   chunk=int(sys.argv[5]), checkpoint_dir=sys.argv[1],
                   **json.loads(sys.argv[3]))
sys.exit("survived past the kill point")
"""


class FlakyChunks:
    """A chunk source that raises ``OSError`` on a fixed schedule
    (``faults``: chunk index -> failures) and re-yields the same chunk on
    the next pull — the supervised source contract."""

    def __init__(self, chunks, faults: dict):
        self.chunks, self.faults, self.i = list(chunks), dict(faults), 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.faults.get(self.i, 0):
            self.faults[self.i] -= 1
            raise OSError(f"planted ingestion fault on chunk {self.i}")
        if self.i >= len(self.chunks):
            raise StopIteration
        self.i += 1
        return self.chunks[self.i - 1]


def runtime_phase(dev, seed: int, counters, reset_counters, rows: dict,
                  G: int = 128, L: int = 1000, K: int = 16,
                  Qcap: int = 4096, A_max: int = 48, T: int = 1000,
                  members: int = PLAIN_MEMBERS,
                  slots: int = PLAIN_SLOTS) -> None:
    """Phase 12: the crash-safe chunked sweep, the supervised stream and
    the audit at the bfjs and vqs paths' width, on the first ``members`` x
    ``slots`` of card-made ensemble streams (the scan engine there is
    host-bound, as the plain versions are); the audit on all ``G`` x
    ``T``.

    (a) a bfjs sweep at load 1.6, chunk 50, SIGKILLed in a child process
        after its second checkpoint and resumed here, equal to one launch
        of the bfjs kernel on the same streams; the carry saved at that
        checkpoint holds a queue (the queue and retry planes are restored);
    (b) a vqs stream (J = 4) at load 0.8 stopped after 3 chunks, its third
        checkpoint truncated, resumed under a Supervisor with the audit
        over a source with planted ingestion faults: one rollback, the
        planted retries, equal to one launch of the vqs kernel;
    (c) ``stream_policy(engine="cuda")`` raises a ValueError naming the
        carry, launching nothing;
    (d) the audited ``"cuda"`` bfjs path at load 0.85 on all members
        passes, and the same result with one occupancy above L fails the
        audit."""
    import os
    import signal
    import tempfile

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.engine import (CheckpointRollbackWarning,
                                         InvariantViolation, RetryPolicy,
                                         Supervisor, SupervisorWarning,
                                         audit_result, chunked,
                                         ensemble_streams,
                                         iter_stream_chunks,
                                         run_policy_streams, stream_policy,
                                         streaming)

    t_phase = time.perf_counter()
    g, Tp, C = members, slots, RUNTIME_CHUNK
    mu, size_mean = 0.01, 0.5
    cfg = dict(L=L, K=K, Qcap=Qcap, A_max=A_max)
    cfg_v = dict(cfg, J=4)
    seeds = range(seed, seed + G)
    saves = {"bfjs": [], "vqs": []}  # (ms, npz bytes) of timed boundaries

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(save, tag):
        def wrapper(checkpoint_dir, step, payload, extra):
            t0 = time.perf_counter()
            save(checkpoint_dir, step, payload, extra)
            saves[tag].append(((time.perf_counter() - t0) * 1e3,
                               os.path.getsize(os.path.join(
                                   checkpoint_dir, f"step_{step:08d}",
                                   "arrays.npz"))))
        return wrapper

    def head(st):
        return type(st)(*(None if x is None else x[:g, :Tp].contiguous()
                          for x in st))

    def launched(tag: str, own: str | None) -> None:
        """The counts since the last reset: ``own`` once, nothing else."""
        got = {n: c.count for n, c in counters.items() if c.count}
        if got != ({} if own is None else {own: 1}):
            raise AssertionError(f"{tag}: launches {got}, expected "
                                 f"{'none' if own is None else own + ' once'}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        # -- 12a. a SIGKILLed bfjs sweep, resumed --------------------------
        # overloaded, so every member's carry holds a queue by the kill
        lam_a = 1.6 * L * mu / size_mean
        full_a = ensemble_streams(seeds, lam_a, mu, uniform(0.1, 0.9), L=L,
                                  K=K, A_max=A_max, horizon=T, device=dev)
        sa = head(full_a)
        del full_a
        planes = os.path.join(tmp, "bfjs_streams.npz")
        np.savez(planes, **{f: getattr(sa, f).cpu().numpy()
                            for f in ("n", "sizes", "durs")})
        ck_a = os.path.join(tmp, "ck_bfjs")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", KILLED_SWEEP, ck_a, planes,
             json.dumps(cfg), str(dev), str(C)],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"12a: the sweep's child ended with "
                                 f"{child.returncode}, not SIGKILL: "
                                 f"{child.stderr[-2000:]}")
        if ckpt.latest_step(ck_a) != 2:
            raise AssertionError(f"12a: checkpoints {ckpt.list_steps(ck_a)} "
                                 "after the kill, expected the newest 2")
        reset_counters()
        real_save = chunked._save_step
        chunked._save_step = timed(real_save, "bfjs")
        try:
            t0 = time.perf_counter()
            got = run_policy_streams(sa, policy="bfjs", engine="scan",
                                     chunk=C, checkpoint_dir=ck_a,
                                     resume=True, **cfg)
            sync()
            resume_s = time.perf_counter() - t0
        finally:
            chunked._save_step = real_save
        launched("12a chunked scan path", None)
        reset_counters()
        want = run_policy_streams(sa, policy="bfjs", engine="cuda",
                                  strict=True, **cfg)
        sync()
        launched("12a comparison", "bfjs")
        if got.queue_len.shape != (g, Tp):
            raise AssertionError("12a: resumed result has the wrong shape")
        require_equal("12a resumed sweep vs the bfjs kernel", got, want)
        q_kill = got.queue_len[:, 2 * C - 1]
        if not int(q_kill.max()) > 0:
            raise AssertionError(f"12a: queues {q_kill.tolist()} at the "
                                 "killed checkpoint; none carried a queue")
        print(f"12a bfjs sweep G={g} L={L} K={K} Qcap={Qcap} "
              f"A_max={A_max} T={Tp} lam={lam_a} chunk={C}: child "
              f"SIGKILLed after checkpoint 2 (rc {child.returncode}, "
              f"{child_s:.1f} s), resumed from step 2 in {resume_s:.1f} s, "
              f"equal to one bfjs kernel launch on every field; queues "
              f"carried through checkpoint 2 {q_kill.tolist()}, mean queue "
              f"{float(got.queue_len.double().mean()):.3f}, truncated "
              f"{int(got.truncated.sum())}, dropped "
              f"{int(got.dropped.sum())}")
        del sa, got, want

        # -- 12b. a supervised vqs stream rolls back and retries -----------
        lam_v = 0.8 * L * mu / size_mean
        full_v = ensemble_streams(seeds, lam_v, mu, uniform(0.1, 0.9), L=L,
                                  K=K, A_max=A_max, horizon=T, device=dev)
        sb = head(full_v)
        del full_v
        sb_host = type(sb)(*(None if x is None else x.cpu() for x in sb))
        ck_b = os.path.join(tmp, "ck_vqs")
        planted = {1: 1, 3: 2}
        sup = Supervisor(retry=RetryPolicy(max_retries=3, seed=seed),
                         quarantine_dir=os.path.join(tmp, "quarantine"))
        real_save = streaming._save_step
        streaming._save_step = timed(real_save, "vqs")
        try:
            reset_counters()
            t0 = time.perf_counter()
            stream_policy(iter_stream_chunks(sb_host, C), policy="vqs",
                          checkpoint_dir=ck_b, stop_after_chunks=3,
                          device=dev, **cfg_v)
            stop_s = time.perf_counter() - t0
            if ckpt.list_steps(ck_b) != [1, 2, 3]:
                raise AssertionError(f"12b: checkpoints "
                                     f"{ckpt.list_steps(ck_b)}")
            victim = os.path.join(ck_b, "step_00000003", "arrays.npz")
            with open(victim, "r+b") as f:
                f.truncate(os.path.getsize(victim) // 2)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", SupervisorWarning)
                t0 = time.perf_counter()
                res = stream_policy(
                    FlakyChunks(iter_stream_chunks(sb_host, C), planted),
                    policy="vqs", checkpoint_dir=ck_b, resume=True,
                    supervisor=sup, audit=True, device=dev, **cfg_v)
                sync()
                stream_s = time.perf_counter() - t0
        finally:
            streaming._save_step = real_save
        launched("12b streaming path", None)
        rows["vqs"]["launches_phase_12"] = counters["vqs"].count
        reset_counters()
        want = run_policy_streams(sb, policy="vqs", engine="cuda",
                                  strict=True, **cfg_v)
        sync()
        launched("12b comparison", "vqs")
        require_equal("12b supervised stream vs the vqs kernel",
                      tuple(res)[:8], tuple(want)[:8])
        rollback_warned = sum(issubclass(w.category,
                                         CheckpointRollbackWarning)
                              for w in caught)
        if (res.rollbacks, res.retries, res.quarantined) != (
                1, sum(planted.values()), 0) or rollback_warned != 1:
            raise AssertionError(
                f"12b: rollbacks {res.rollbacks}, retries {res.retries}, "
                f"quarantined {res.quarantined}, rollback warnings "
                f"{rollback_warned}; expected 1, "
                f"{sum(planted.values())}, 0, 1")
        mean_q = float(res.queue_len.double().mean())
        if not mean_q > 0:
            raise AssertionError("12b: the vqs stream never queued")
        print(f"12b vqs stream G={g} J=4 L={L} K={K} Qcap={Qcap} "
              f"A_max={A_max} T={Tp} lam={lam_v} chunk={C}: stopped after "
              f"3 chunks ({stop_s:.1f} s), step 3 truncated, resumed under "
              f"the supervisor with the audit in {stream_s:.1f} s: "
              f"rollbacks {res.rollbacks}, retries {res.retries} (planted "
              f"{sum(planted.values())}), quarantined {res.quarantined}; "
              f"equal to one vqs kernel launch on every field; mean queue "
              f"{mean_q:.3f}")
        print(f"12b streaming counters (resumed run, {Tp // C - 2} "
              f"chunks): chunks_behind {res.chunks_behind}, host_stall_us "
              f"{res.host_stall_us:.1f}")
        for tag, boundary in saves.items():
            ms = [m for m, _ in boundary]
            print(f"12 checkpoint boundaries {tag}: {len(ms)} saves, "
                  f"{np.mean(ms):.1f} ms mean ({min(ms):.1f}-"
                  f"{max(ms):.1f}), {boundary[-1][1]} bytes of arrays.npz "
                  f"a boundary ({g} members)")

        # -- 12c. the "cuda" request cannot carry a stream ------------------
        reset_counters()
        try:
            stream_policy(iter_stream_chunks(sb, C), policy="vqs",
                          engine="cuda", device=dev, **cfg_v)
        except ValueError as e:
            if "carry a streaming run" not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("12c: engine=\"cuda\" streaming was not "
                                 "refused")
        launched("12c cuda streaming request", None)
        print(f"12c stream_policy(engine=\"cuda\"): ValueError "
              f"({refused[:72]}...); no kernel launched")
        del sb, sb_host, res, want

        # -- 12d. the audit at full width ---------------------------------
        lam_d = 0.85 * L * mu / size_mean
        full_b = ensemble_streams(seeds, lam_d, mu, uniform(0.1, 0.9), L=L,
                                  K=K, A_max=A_max, horizon=T, device=dev)
        reset_counters()
        t0 = time.perf_counter()
        res = run_policy_streams(full_b, policy="bfjs", engine="cuda",
                                 strict=True, audit=True, **cfg)
        sync()
        audit_ms = (time.perf_counter() - t0) * 1e3
        launched("12d audited bfjs path", "bfjs")
        rows["bfjs"]["launches_phase_12"] = counters["bfjs"].count
        if res.queue_len.shape != (G, T):
            raise AssertionError("12d: wrong result shape")
        evil = res.occupancy.clone()
        evil[G // 2, T // 2] = L + 1.0
        try:
            audit_result(full_b, res._replace(occupancy=evil),
                         policy="bfjs", config=cfg)
        except InvariantViolation as e:
            if e.invariant != "occupancy_capacity":
                raise
        else:
            raise AssertionError("12d: an occupancy above L passed the "
                                 "audit")
        print(f"12d audited bfjs path G={G} L={L} T={T} lam={lam_d}: "
              f"run_policy_streams(engine=\"cuda\", audit=True) passes in "
              f"{audit_ms:.1f} ms (kernel + audit, host clock); occupancy "
              f"L + 1 at one slot fails occupancy_capacity")
        del full_b, res, evil
    print(f"chunked, streaming and supervised phase: "
          f"{time.perf_counter() - t_phase:.1f} s")


#: Widths of phase 13's sharded paths: the bfjs, vqs, vqs-bf and bfjs-mr
#: paths of phases 4-6 (L = 1000, K = 16, A_max = 48, 128 members x 1000
#: slots, sizes U[0.1, 0.9], mu = 0.01), each at its own load.
FLEET_PATHS = {
    "bfjs": ("bfjs", 0.85, dict(Qcap=4096), 1),
    "vqs": ("vqs", 0.6, dict(J=4, Qcap=1024), 1),
    "vqs-bf": ("vqs_bf", 0.6, dict(J=4, Qcap=1024), 1),
    "bfjs-mr": ("bfjs_mr", 0.8, dict(Qcap=1024), 2),
}


#: 13c's work lists, all shorter than the default ``A_max + 4`` = 52: on
#: the vqs path at load 0.6 the short ones truncate and are rejected, the
#: long ones bit-match the default and may win.
FLEET_TUNE_GRID = (8, 16, 24, 32, 40, 48)


def launched_only(tag: str, counters, want: dict) -> None:
    """The launches since the last reset are exactly ``want``."""
    got = {n: c.count for n, c in counters.items() if c.count}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def fleet_phase(dev, seed: int, counters, reset_counters, G: int = 128,
                L: int = 1000, K: int = 16, A_max: int = 48, T: int = 1000,
                members: int = PLAIN_MEMBERS,
                slots: int = PLAIN_SLOTS) -> None:
    """Phase 13a-d: the ensemble split over devices, a chunked sweep
    resumed on another shard count, the tuner and ``estimate_capacity``.

    The mesh is ``[dev, dev]`` on a one-card machine (a repeated device,
    two shards on one card) and ``devices=torch.cuda.device_count()``
    where there are more.

    (a) ``monte_carlo_policy(engine="cuda", devices=...)`` on the four
        scheduler paths at full width equals the unsharded launch on every
        field, one launch of the path's kernel a shard and no other;
    (b) a chunked bfjs sweep at load 1.6 on the first ``members`` x
        ``slots`` of card-made streams, stopped after 2 chunks on 2 shards
        and resumed on 1, equals one bfjs kernel launch;
    (c) ``autotune(engine="cuda")`` on the vqs path at load 0.6 over
        ``FLEET_TUNE_GRID`` into a throwaway cache: some of those shorter
        work lists are rejected (they truncate), some bit-match the
        default and survive, the winner is cached, and
        ``monte_carlo_policy`` finds it (a cache hit) and equals the
        untuned run.  The card's kernels leave a slot's work list as soon
        as nothing is pending, so a shorter list saves little time: the
        winner's speedup is within noise;
    (d) ``estimate_capacity`` on 1000 replicas at load 0.85 (mu = 0.01,
        A_max = 48, 128 members, 1000 slots, the default U[0.05, 0.5] law,
        104 work steps) unsharded and on the mesh: equal dicts but for
        ``devices``, nothing truncated; then 500 replicas at the same
        traffic, which must saturate."""
    import os
    import tempfile

    import torch
    from repro_torch.core.engine import (TuningCache, Workload,
                                         apply_tuned, autotune,
                                         ensemble_streams,
                                         monte_carlo_policy,
                                         run_policy_streams)
    from repro_torch.serving.engine import estimate_capacity

    ncard = torch.cuda.device_count()
    devices = [dev, dev] if ncard == 1 else ncard
    D = 2 if ncard == 1 else ncard
    mesh_name = f"[{dev}, {dev}]" if ncard == 1 else f"{ncard} cards"
    mu, size_mean = 0.01, 0.5
    seeds = range(seed, seed + G)

    # -- 13a. sharded == unsharded on the four paths ------------------------
    for policy, (name, load, extra, R) in FLEET_PATHS.items():
        lam = load * L * mu / size_mean
        wl = Workload(lam=lam, mu=mu, sampler=uniform(0.1, 0.9, R),
                      num_resources=R)
        cfg = dict(L=L, K=K, A_max=A_max, horizon=T, **extra)
        reset_counters()
        one_ms, ref = wall_ms(lambda: monte_carlo_policy(
            wl, seeds=seeds, policy=policy, engine="cuda", strict=True,
            device=dev, **cfg))
        launched_only(f"13a {policy} unsharded", counters, {name: 1})
        reset_counters()
        shard_ms, res = wall_ms(lambda: monte_carlo_policy(
            wl, seeds=seeds, policy=policy, engine="cuda", strict=True,
            devices=devices, **cfg))
        launched_only(f"13a {policy} on {mesh_name}", counters, {name: D})
        require_equal(f"13a {policy} sharded vs unsharded", res, ref)
        print(f"13a {policy} G={G} L={L} T={T} load {load}: on {mesh_name} "
              f"equal to the unsharded run on every field; {name} launches "
              f"{D} (one a shard); wall {shard_ms:.1f} ms sharded, "
              f"{one_ms:.1f} ms unsharded (streams + kernels, host clock); "
              f"truncated {int(res.truncated.sum())}")
        del ref, res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        # -- 13b. a chunked sweep checkpointed on 2 shards, resumed on 1 ---
        cfg = dict(L=L, K=K, Qcap=4096, A_max=A_max)
        lam = 1.6 * L * mu / size_mean
        full = ensemble_streams(seeds, lam, mu, uniform(0.1, 0.9), L=L,
                                K=K, A_max=A_max, horizon=T, device=dev)
        st = type(full)(*(None if x is None else
                          x[:members, :slots].contiguous() for x in full))
        del full
        ck = os.path.join(tmp, "ck")
        reset_counters()
        t0 = time.perf_counter()
        part = run_policy_streams(st, policy="bfjs", engine="scan",
                                  chunk=RUNTIME_CHUNK, checkpoint_dir=ck,
                                  stop_after_chunks=2, devices=[dev, dev],
                                  **cfg)
        t1 = time.perf_counter()
        got = run_policy_streams(st, policy="bfjs", engine="scan",
                                 chunk=RUNTIME_CHUNK, checkpoint_dir=ck,
                                 resume=True, devices=[dev], **cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched_only("13b chunked scan path", counters, {})
        if part.queue_len.shape != (members, 2 * RUNTIME_CHUNK):
            raise AssertionError("13b: the stopped sweep ran the wrong "
                                 "number of chunks")
        want = run_policy_streams(st, policy="bfjs", engine="cuda",
                                  strict=True, **cfg)
        require_equal("13b resumed on 1 shard vs the bfjs kernel", got, want)
        print(f"13b bfjs sweep G={members} T={slots} lam={lam} chunk="
              f"{RUNTIME_CHUNK}: 2 chunks on 2 shards in {t1 - t0:.1f} s, "
              f"resumed on 1 shard in {t2 - t1:.1f} s, equal to one bfjs "
              f"kernel launch on every field; mean queue "
              f"{float(got.queue_len.double().mean()):.3f}")
        del st, part, got, want

        # -- 13c. the tuner: a verified winner, found again -----------------
        name, load, extra, _ = FLEET_PATHS["vqs"]
        wl = Workload(lam=load * L * mu / size_mean, mu=mu,
                      sampler=uniform(0.1, 0.9))
        cfg = dict(L=L, K=K, A_max=A_max, horizon=T, device=dev, **extra)
        env = "REPRO_TORCH_TUNING_CACHE"
        path = os.path.join(tmp, "sched_tuning.json")
        os.environ[env] = path
        try:
            t0 = time.perf_counter()
            # (allow_plain only for a rehearsal on the CPU)
            tuned = autotune(wl, seeds, policy="vqs", engine="cuda",
                             work_steps_grid=FLEET_TUNE_GRID, rounds=3,
                             allow_plain=dev.type == "cpu", **cfg)
            tune_s = time.perf_counter() - t0
            entry = TuningCache(path).get(tuned["key"])
            if entry is None or entry["work_steps"] != tuned["work_steps"]:
                raise AssertionError("13c: the winner was not cached")
            default_ws = A_max + 4
            if not (tuned["candidates"] and tuned["rejected"]):
                raise AssertionError(
                    f"13c: of {FLEET_TUNE_GRID}, all below the default "
                    f"{default_ws}, {tuned['candidates']} bit-matched and "
                    f"{tuned['rejected']} were rejected; the sweep should "
                    "keep some and reject the short ones")
            probe = dict(cfg)
            meta = apply_tuned("vqs", "cuda", probe)
            if meta["cache_hit"] != 1 \
                    or probe.get("work_steps") != tuned["work_steps"]:
                raise AssertionError(f"13c: no cache hit ({meta})")
            reset_counters()
            res = monte_carlo_policy(wl, seeds, policy="vqs", engine="cuda",
                                     strict=True, **cfg)
            launched_only("13c tuned path", counters, {name: 1})
        finally:
            os.environ[env] = "off"
        base = monte_carlo_policy(wl, seeds, policy="vqs", engine="cuda",
                                  strict=True, **cfg)
        require_equal("13c tuned vs untuned vqs path", res, base)
        print(f"13c autotune vqs path G={G} L={L} T={T} load {load} "
              f"(engine cuda): of work_steps {FLEET_TUNE_GRID}, all below "
              f"the default {default_ws}, {tuned['candidates']} bit-match "
              f"the default run with nothing truncated and "
              f"{tuned['rejected']} are rejected; winner "
              f"{tuned['work_steps'] or f'the default {default_ws}'} "
              f"at {tuned['us'] / 1e3:.2f} ms against {tuned['baseline_us'] / 1e3:.2f} ms "
              f"(speedup {tuned['speedup']}, host clock, streams + kernel, "
              f"best of 3); sweep {tune_s:.1f} s; monte_carlo_policy: "
              f"cache hit {meta['cache_hit']}, tuned {meta['tuned']}, equal "
              f"to the untuned run on every field")
        del res, base

    # -- 13d. estimate_capacity at the paper's width ------------------------
    mean_slots, law_mean = 1.0 / mu, 0.275   # U[0.05, 0.5]
    lam = 0.85 * L / (mean_slots * law_mean)
    # at the default work list (A_max + 4 = 52 steps) about a third of
    # this traffic's slots truncate (PERF.md, PR 24); twice that truncates
    # none, so the estimate is the exact BF-J/S
    kw = dict(ensembles=G, horizon=T, A_max=A_max, engine="cuda",
              seed=seed, work_steps=2 * (A_max + 4))
    reset_counters()
    one_ms, one = wall_ms(lambda: estimate_capacity(L, lam, mean_slots,
                                                    device=dev, **kw))
    launched_only("13d estimate_capacity", counters, {"bfjs": 1})
    reset_counters()
    shard_ms, sharded = wall_ms(lambda: estimate_capacity(
        L, lam, mean_slots, devices=devices, **kw))
    launched_only("13d estimate_capacity on the mesh", counters,
                  {"bfjs": D})
    if sharded != {**one, "devices": D}:
        raise AssertionError(f"13d: sharded {sharded} != unsharded {one}")
    if one["truncated"]:
        raise AssertionError(f"13d: {one['truncated']} slots truncated")
    small = estimate_capacity(L // 2, lam, mean_slots, device=dev, **kw)
    if not small["mean_tail_queue"] > 10 * max(one["mean_tail_queue"], 0.1):
        raise AssertionError(f"13d: {L // 2} replicas did not saturate: "
                             f"{small}")
    print(f"13d estimate_capacity({L} replicas, lam={lam:.4f}, mean "
          f"service {mean_slots:g} slots, {G} members x {T} slots, "
          f"engine cuda): {one}; {one_ms:.1f} ms unsharded, {shard_ms:.1f} "
          f"ms on {mesh_name} (host clock), equal but for devices; "
          f"{L // 2} replicas saturate: mean tail queue "
          f"{small['mean_tail_queue']:.1f}, p95 {small['p95_tail_queue']:g}, "
          f"dropped {small['dropped']}, truncated {small['truncated']}")


def live_op_bytes(op: str, ev, pre: tuple, post: tuple, out) -> int:
    """Bytes one admission op must move on this run's data: every word it
    needs read once, every word it changes written once.  ``pre`` and
    ``post`` are the state's (residual, q_rid, q_size, q_len) as numpy
    before and after the op, ``out`` its out buffer.

    All ops read and write the three counters and write the 4-word header;
    the residual and queue words that changed are written, and each moved
    queue word's source read.  On top: event lanes read (admit, release,
    tick); admit reads every residual (BF-J's least fit) and writes its
    placements; release and tick read the residuals their live lanes name;
    refill reads its replica's; BF-S (refill, and tick when a replica was
    named) scans the live lanes' sizes and writes the placed ids and
    replicas.  Words that kept their value are not counted, so this is a
    floor of what the op must touch."""
    from repro_torch.kernels.live_admission.ref import HEADER
    res0, qr0, qs0, n0 = pre
    res1, qr1, qs1, _ = post
    moved = int((qr0 != qr1).sum() + (qs0 != qs1).sum())
    words = 3 + 3 + HEADER + int((res0 != res1).sum()) + moved
    if ev is not None:
        words += ev.size
    if op == "admit":
        words += res0.size + ev.shape[1]
    named = 0
    if op in ("release", "tick"):
        rep = ev[0][(ev[2] != 0) & (ev[0] >= 0) & (ev[0] < res0.size)]
        named = np.unique(rep).size
        words += named
    if op == "refill":
        words += 1
    if op == "refill" or (op == "tick" and named):
        words += n0 + moved + 2 * int(out[0])
    if op == "push_front":
        words += moved
    return 4 * words


#: (replicas, Qcap, event lanes) of the live admission checks: the serve
#: fleet of 13e (one replica, the default Qcap, b_slots lanes) first, the
#: shape the kernels line reports; then a short queue that overflows and
#: drops tails, a wide fleet and a deep queue.
LIVE_SHAPES = ((1, 512, 3), (2, 8, 6), (64, 512, 64), (1000, 4096, 256))


def live_kernel_phase(dev, seed: int, counters, reset_counters,
                      n_ops: int = 300) -> dict:
    """Phase 13e, the kernel: the live admission kernel against its plain
    version on random op sequences (``sequences.random_ops``) at
    ``LIVE_SHAPES``, every out buffer and the final state exactly; an
    invalid release raising on the next read on the card; the times per
    call of the kernel and the plain version, the bound from
    ``live_op_bytes``, and per tick of the host controller and of the
    card's facade.  Returns the kernels line's row (without
    ``launches``)."""
    import torch
    from repro_torch.cluster.admission import (AdmissionController,
                                               PendingJob)
    from repro_torch.core.engine import InvariantViolation
    from repro_torch.kernels.live_admission.sequences import (random_ops,
                                                              replay, stage)
    from repro_torch.serving.live import LiveAdmission, init_state

    rng = np.random.default_rng(seed)
    row, dropped, invalid = None, 0, 0

    def snapshot(st):
        return (st.residual.numpy().copy(), st.q_rid.numpy().copy(),
                st.q_size.numpy().copy(), int(st.q_len))

    for L, Qcap, width in LIVE_SHAPES:
        ops = random_ops(rng, L, n_ops, width)
        on_cpu, on_card = stage(ops, "cpu"), stage(ops, dev)
        plain = init_state(L, Qcap, "cpu")
        want, plain_s, nbytes = [], 0.0, 0
        for (op, ev, _, _), staged in zip(ops, on_cpu):
            pre = snapshot(plain)
            t0 = time.perf_counter()
            want += replay(plain, [staged])
            plain_s += time.perf_counter() - t0
            nbytes += live_op_bytes(op, ev, pre, snapshot(plain),
                                    want[-1].numpy())
        plain_ms = plain_s * 1e3 / len(ops)
        nbytes /= len(ops)
        card = init_state(L, Qcap, dev)
        reset_counters()
        got = replay(card, on_card)
        launched_only(f"13e kernel check L={L} Qcap={Qcap}", counters,
                      {"live_admission": len(ops)})
        err = 0
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise AssertionError(f"13e L={L} Qcap={Qcap}: op {i} "
                                     f"({ops[i][0]}) differs from plain")
        for f in plain._fields:
            a, b = getattr(card, f).cpu(), getattr(plain, f)
            err = max(err, int((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"13e L={L} Qcap={Qcap}: state {f}")
        dropped += int(plain.dropped)
        invalid += int(plain.invalid)
        # time a replay with no reads back: each op one launch
        timed = init_state(L, Qcap, dev)
        ms = time_ms(lambda: replay(timed, on_card, read=False),
                     reps=3) / len(ops)
        b_ms, b_by = bound(nbytes, 0)
        print(f"13e live admission kernel L={L} Qcap={Qcap} lanes={width}: "
              f"{len(ops)} random ops equal to plain (exact; dropped "
              f"{int(plain.dropped)}, invalid {int(plain.invalid)}, queue "
              f"{int(plain.q_len)}); kernel {ms:.4f} ms a call (CUDA "
              f"events over a replay, launches issued back to back), plain "
              f"{plain_ms:.4f} ms a call (host), bound {b_ms:.6f} ms "
              f"({b_by}: {nbytes:.0f} B a call, the mean of what each op "
              "must read and write on this data; below the card's launch "
              "latency)")
        if row is None:
            row = dict(name="live_admission", route="cuda",
                       source="src/repro_torch/kernels/csrc/live_admission.cu",
                       replaces="src/repro/serving/live.py:200",
                       max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       shape=dict(L=L, Qcap=Qcap, lanes=width))

    if not (dropped and invalid):
        raise AssertionError("13e: no queue overflow or invalid release was "
                             "compared")
    # an invalid release is counted on the card and raised on the next read
    live = LiveAdmission(2, Qcap=8, device=dev)
    live.release(0, (1 << 16) + 1)
    try:
        live.queue_len()
    except InvariantViolation as e:
        if e.invariant != "occupancy_capacity":
            raise
    else:
        raise AssertionError("13e: an invalid release was not raised")

    # a tick on the host controller and on the card's facade
    for L in (1, 64):
        per = {}
        for kind in ("host", "live"):
            # at most 20 jobs of >= 0.05 on a replica: 32 lanes a replica
            ctl = AdmissionController(L) if kind == "host" else \
                LiveAdmission(L, Qcap=512, tick_width=32 * L, device=dev)
            r = np.random.default_rng(seed)
            active, size_of, rid, t_s, ticks = {}, {}, 0, 0.0, 200
            for _ in range(ticks):
                # load ~0.69: L / 2 arrivals of mean 0.275, 5 ticks each
                jobs = [PendingJob(rid=rid + i, frac=float(
                    r.uniform(0.05, 0.5))) for i in range(int(r.integers(
                        0, L + 1)))]
                rid += len(jobs)
                size_of.update({j.rid: j.size for j in jobs})
                events = [(active.pop(x), size_of[x]) for x in list(active)
                          if r.uniform() < 0.2]
                t0 = time.perf_counter()
                active.update(ctl.admit(jobs))
                if kind == "host":
                    for rep, size in events:
                        ctl.release(rep, size)
                    placed = []
                    for rep in sorted({rep for rep, _ in events}):
                        placed += ctl.refill(rep)
                else:
                    placed = ctl.tick(events)
                ctl.queue_len()
                t_s += time.perf_counter() - t0
                active.update(placed)
            per[kind] = (t_s * 1e3 / ticks, ctl.queue_len())
        if per["host"][1] != per["live"][1]:
            raise AssertionError(f"13e L={L}: host and live queues differ")
        print(f"13e a tick (admit + releases + refills) over {L} "
              f"replica(s), 200 random ticks: host controller "
              f"{per['host'][0]:.4f} ms, live facade on the card "
              f"{per['live'][0]:.4f} ms (host clock, launches and reads "
              f"back included); final queues equal ({per['host'][1]})")
        row[f"host_tick_ms_L{L}"] = per["host"][0]
        row[f"live_tick_ms_L{L}"] = per["live"][0]
    return row


def live_requests(rng, vocab: int) -> list:
    """13e's traffic: 12 requests, prompts U[8, 48] tokens (three of them
    64 longer), U[2, 8] new tokens, submitted at once to one replica of 3
    slots and a 192-token cache, so that the queue fills and requests that
    fit its memory but find no free slot go back to the queue's head."""
    from repro_torch.serving.engine import Request
    lengths = rng.integers(8, 49, 12)
    max_new = rng.integers(2, 9, 12)
    lengths[rng.integers(0, 12, 3)] += 64
    return [Request(rid=i, prompt=rng.integers(1, vocab, int(n)).astype(
        np.int32), max_new=int(m))
        for i, (n, m) in enumerate(zip(lengths, max_new))]


def live_serve(cfg, params, dev, seed: int, counters,
               reset_counters) -> dict:
    """Phase 13e, the path: llama3-8b at full width on the serve path's
    weights behind ``ServingEngine(admission="live")`` and ``"host"`` (one
    replica, b_slots 3, c_max 192, audited), the same ``live_requests``:
    placements, tokens and stats equal; the live engine launches the
    admission kernel once a controller call and decode_attention once a
    layer a decode step, and the host engine no admission kernel."""
    import torch
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    runs = {}
    for admission in ("host", "live"):
        engine = ServingEngine(cfg, params, num_replicas=1, b_slots=3,
                               c_max=192, policy="bf", admission=admission,
                               audit=True, device=dev)
        reqs = live_requests(np.random.default_rng(seed), cfg.vocab_size)
        decodes = []
        rep = engine.replicas[0]
        rep.decode = lambda toks, pos, _d=rep.decode: decodes.append(1) \
            or _d(toks, pos)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.submit(reqs)
        done = engine.run(max_steps=5_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: c.count for n, c in counters.items() if c.count}
        calls = getattr(engine.admission, "calls", 0)
        ticks = len(engine.stats["queue_len"])
        want = {"decode_attention": cfg.num_layers * len(decodes)}
        if calls:
            want["live_admission"] = calls
        if got != want or (admission == "live") != (calls > 0):
            raise AssertionError(f"13e {admission} serve: launches {got}, "
                                 f"expected {want}")
        if len(done) != 12 or any(len(r.out) != r.max_new for r in done):
            raise AssertionError(f"13e {admission} serve: not every request "
                                 "completed")
        runs[admission] = ([(r.rid, r.replica, r.slot, r.out)
                            for r in done], engine.stats, wall, ticks, calls)
        del engine
    host, live = runs["host"], runs["live"]
    if live[0] != host[0] or live[1] != host[1]:
        raise AssertionError("13e: the live engine's placements, tokens or "
                             "stats differ from the host engine's")
    stats = live[1]
    if not (max(stats["queue_len"]) > 0 and stats["rejected_slots"] > 0):
        raise AssertionError("13e: the queue never filled or no slot was "
                             "rejected")
    print(f"13e serve llama3-8b (full width, bf16) behind live and host "
          f"admission: 12 requests, 1 replica x 3 slots, c_max 192: equal "
          f"placements, tokens and stats; {live[3]} ticks, max queue "
          f"{max(stats['queue_len'])}, admitted {stats['admitted']}, slot "
          f"rejections {stats['rejected_slots']}; live: {live[4]} "
          f"controller calls = {live[4]} live_admission launches, "
          f"{live[2]:.2f} s; host {host[2]:.2f} s (host clock)")
    return {"launches": live[4], "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 14: MLA, MoE and the sliding-window ring at full width
# ---------------------------------------------------------------------------
#: The deepseek-v2-lite-16b gates' prompt length (teacher-forced decode and
#: prefill, kernels against plain versions).
MOE_GATE_TOKENS = 128

#: Layers of the float32 deepseek gate: the full width at 27 layers is
#: 65 GB in float32; 4 layers keep every layer kind (MLA, MoE) at it.
MOE_GATE_F32_LAYERS = 4

#: Limit of the bf16 deepseek gate (kernels against plain versions, the
#: kernel run on the plain run's expert picks), as max |diff| / max
#: |logit|.  The float32 gate at ``GATE_TOL`` decides.  In bf16, 27
#: layers of MLA and MoE (whose expert stacks draw at fan-in E, as in
#: JAX, so their outputs are large) put sound pinned readings over bf16's
#: 3e-2: decode 0.0353 / 0.0407 / 0.0466 and prefill 0.0365 / 0.0290 /
#: 0.0304 on seeds 0-2; unpinned, a 1-ulp difference tips a router's near
#: tie and the runs part (1.13).  Both kernels' softmax scale off by 1%
#: reads 0.0736 and more, off by 0.5% 0.0563 / 0.0635 (seed 0,
#: tools/attention_margins.py).  6e-2 sits between the sound and the 1%
#: readings, 1.29x and 1.23x from them (PERF.md, section 6).
MOE_BF16_TOL = 6e-2

#: h2o-danube-3-4b's serve cache (twice its window) and prefill length.
DANUBE_C_MAX = 8192


def param_count(tree) -> int:
    """Elements in a parameter dictionary (nested dicts and lists)."""
    if isinstance(tree, dict):
        return sum(param_count(x) for x in tree.values())
    if isinstance(tree, list):
        return sum(param_count(x) for x in tree)
    return tree.numel()


def cast_params(tree, dtype):
    """A copy of a parameter dictionary with every tensor in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


class PinnedRouting:
    """Inside the context, ``moe.route`` records each call's expert picks
    and, once ``replay()`` is called, hands the recorded picks back in the
    same order, with the weights renormalised from the caller's own
    probabilities.  The bf16 MoE gate compares the kernels with the plain
    versions this way: a 1-ulp difference in an attention output tips a
    router's near tie in bf16, and the two runs would then route tokens
    to other experts."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.picks, self.at = moe, moe.route, [], None

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def replay(self) -> None:
        self.at = 0

    def done(self) -> bool:
        return self.at == len(self.picks)

    def _route(self, params, xf, cfg):
        probs, top_w, top_e = self.route(params, xf, cfg)
        if self.at is None:
            self.picks.append(top_e)
            return probs, top_w, top_e
        top_e = self.picks[self.at]
        self.at += 1
        top_w = probs.gather(-1, top_e)
        return probs, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), \
            top_e


def moe_gate(cfg, params, prompt, pin: bool = False) -> dict[str, float]:
    """The teacher-forced gate of an MoE model, as max |diff| / max |logit|:
    ``decode_step`` with the kernels against the plain versions over every
    token of ``prompt`` (1, P) (``kernels``), and ``prefill`` likewise
    (``prefill``).  Prefill is not held to the last decode step: its
    capacity is taken over all P tokens and may drop some (JAX's does the
    same), while decode routes each row alone and never drops.  ``pin``
    runs the kernels on the plain run's expert picks
    (:class:`PinnedRouting`)."""
    import contextlib

    import torch
    from repro_torch.models import model as M
    P = prompt.shape[1]
    logits, last = {}, {}
    with PinnedRouting() if pin else contextlib.nullcontext() as pinned:
        for use in (False, True):
            if pin and use:
                pinned.replay()
            caches = M.init_cache(cfg, 1, P, device=prompt.device)
            steps = []
            for i in range(P):
                out, caches = M.decode_step(params, cfg, prompt[:, i:i + 1],
                                            i, caches, use_kernels=use)
                steps.append(out[:, 0])
            logits[use] = torch.cat(steps)
            last[use] = M.prefill(params, cfg, tokens=prompt,
                                  use_kernels=use)
            del caches
        if pin and not pinned.done():
            raise AssertionError("pinned routing: the runs routed a "
                                 "different number of times")

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    return dict(kernels=rel(logits[True], logits[False]),
                prefill=rel(last[True], last[False]))


def check_gate(tag: str, r: dict, tol: float) -> None:
    print(f"{tag}: decode with kernels vs plain versions max |diff| / max "
          f"|logit| = {r['kernels']:.4g}; prefill with kernels vs plain "
          f"{r['prefill']:.4g} (gate {tol:g} each)")
    if not r["kernels"] <= tol or not r["prefill"] <= tol:
        raise AssertionError(f"{tag}: teacher-forced gate failed")


def short_requests(rng, vocab: int, n: int, prompt: tuple, new: tuple
                   ) -> list:
    """``n`` requests, prompts U[prompt] tokens, U[new] new tokens."""
    from repro_torch.serving.engine import Request
    lengths = rng.integers(prompt[0], prompt[1] + 1, n)
    max_new = rng.integers(new[0], new[1] + 1, n)
    return [Request(rid=i, prompt=rng.integers(1, vocab, int(m)).astype(
        np.int32), max_new=int(k)) for i, (m, k) in enumerate(
        zip(lengths, max_new))]


def serve_and_count(tag: str, cfg, engine, decode_s, reqs, counters,
                    reset_counters, layers: int) -> dict:
    """Run ``reqs`` through ``engine`` with the counters set to 0 just
    before; requires one decode launch per attention layer and replica
    tick, no other launch; prints the tick time and token rates."""
    import torch
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.submit(reqs)
    done = engine.run(max_steps=20_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.count for n, c in counters.items()}
    calls = len(decode_s)
    check_served(tag, cfg, engine, done, len(reqs))
    if launches["decode_attention"] != layers * calls or any(
            c for n, c in launches.items() if n != "decode_attention"):
        raise AssertionError(f"{tag}: launches {launches}, expected "
                             f"{layers} decode_attention a replica tick "
                             f"({calls}) and nothing else")
    generated = sum(len(r.out) for r in done)
    processed = sum(r.pos for r in done)
    print(f"{tag}: {len(reqs)} requests, max queue "
          f"{max(engine.stats['queue_len'])}, {len(engine.stats['queue_len'])}"
          f" ticks, {calls} replica decode steps in {wall:.2f} s; generated "
          f"{generated} tokens ({generated / wall:.1f} tokens/s), processed "
          f"{processed} ({processed / wall:.1f} tokens/s); decode step "
          f"{np.mean(decode_s) * 1e3:.2f} ms mean per replica tick (host "
          f"clock, synchronised); decode_attention launches "
          f"{launches['decode_attention']}")
    return launches


def deepseek_path(dev, seed: int, counters, reset_counters) -> dict:
    """14a: deepseek-v2-lite-16b at full width (27 layers, MLA, 64 routed
    experts top-6 and 2 shared, bf16, weights from ``seed``): the bf16
    teacher-forced gate over ``MOE_GATE_TOKENS`` tokens, a serve through
    ``timed_engine`` with traffic cut to the phase's budget, one
    2048-token prefill and a profile of one decode step, then the float32
    gate at ``MOE_GATE_F32_LAYERS`` layers.  Returns the path's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("deepseek-v2-lite-16b")
    torch.cuda.reset_peak_memory_stats()
    init_ms, params = wall_ms(lambda: M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev))
    print(f"deepseek: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model}, MLA r={cfg.kv_lora_rank} nope/rope/v "
          f"{cfg.qk_nope_dim}/{cfg.qk_rope_dim}/{cfg.v_head_dim}, "
          f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} + "
          f"{cfg.num_shared_experts} shared of d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {param_count(params) / 1e9:.3f} B"
          f" parameters drawn on the card in {init_ms / 1e3:.1f} s")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, MOE_GATE_TOKENS)).astype(np.int64)).to(dev)
    check_gate(f"deepseek: teacher-forced {MOE_GATE_TOKENS}-token prompt, "
               f"bf16 seed {seed}, {cfg.num_layers} layers, expert picks "
               f"pinned to the plain run's",
               moe_gate(cfg, params, prompt, pin=True), MOE_BF16_TOL)

    engine, decode_s = timed_engine(cfg, params, dev)
    reqs = short_requests(rng, cfg.vocab_size, 10, (48, 96), (8, 24))
    long_prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, 2048)).astype(np.int64)).to(dev)
    launches = serve_and_count("deepseek serve", cfg, engine, decode_s, reqs,
                               counters, reset_counters, cfg.num_layers)
    reset_counters()
    out = M.prefill(params, cfg, tokens=long_prompt)
    torch.cuda.synchronize()
    flash = counters["flash_attention"].count
    if flash != cfg.num_layers or any(
            c.count for n, c in counters.items() if n != "flash_attention"):
        raise AssertionError(f"deepseek prefill: flash launches {flash}, "
                             f"expected {cfg.num_layers} and nothing else")
    if out.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(out)
                                                   .all()):
        raise AssertionError("deepseek: prefill logits bad shape or values")
    launches["flash_attention"] = flash
    prefill_ms = time_ms(lambda: M.prefill(params, cfg, tokens=long_prompt),
                         3)
    print(f"deepseek: prefill S=2048 {prefill_ms:.1f} ms (CUDA events, mean "
          f"of 3), flash_attention launches {flash}; device memory peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del engine
    profile_decode_step(cfg, params, dev, "deepseek")
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(dtype="float32", num_layers=MOE_GATE_F32_LAYERS)
    params = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    check_gate(f"deepseek: teacher-forced {MOE_GATE_TOKENS}-token prompt, "
               f"f32 seed {seed}, {cfg32.num_layers} layers at full width",
               moe_gate(cfg32, params, prompt), GATE_TOL["float32"])
    del params
    torch.cuda.empty_cache()
    return launches


def ring_linear_check(calls, C: int, window: int, gen) -> float:
    """Hold each recorded plain float32 ring decode (``(q, k, v, pos,
    out)`` of every layer) to the linear computation: the same keys and
    values laid out by stored position in ``max(pos) + 1`` slots (the
    others filled with other values), through ``decode_attention_ref``
    with the window, within 2e-5.  Returns the largest difference."""
    import torch
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    worst = 0.0
    for q, k, v, pos, out in calls:
        B, KV, _, hd = k.shape
        T = int(pos.max()) + 1
        lin_k = torch.randn((B, KV, T, hd), generator=gen, device=k.device)
        lin_v = torch.randn((B, KV, T, hd), generator=gen, device=k.device)
        for b, p in enumerate(pos.tolist()):
            t = torch.arange(max(p - C + 1, 0), p + 1, device=k.device)
            lin_k[b, :, t] = k[b, :, t % C]
            lin_v[b, :, t] = v[b, :, t % C]
        lin = decode_attention_ref(q, lin_k, lin_v, pos, window=window)
        worst = max(worst, attn_check("plain ring decode vs the linear "
                                      "window (float32)", out, lin))
        del lin_k, lin_v
    return worst


#: Limit of 14b's bf16 ring step, kernels against plain versions, as max
#: |diff| / max |logit|.  The float32 step decides (sound 4.8e-6); in
#: bf16, 24 layers over rings of random values put sound steps at 0.0315
#: / 0.0321 / 0.0270 (seeds 0-2), over bf16's 3e-2.  The decode kernel's
#: softmax scale off by 1% reads 0.0647 and more, off by 0.5% 0.0525, its
#: window test on the wrapped ring (``window=4096``) 1.24 (seed 0,
#: tools/attention_margins.py).  4.5e-2 sits between the sound and the
#: 1% readings, 1.40x and 1.44x from them (PERF.md, section 6).
RING_BF16_TOL = 4.5e-2


def ring_step(cfg, params, src, tok, pos, counters, reset_counters,
              record=None):
    """One ``decode_step`` of the rows at ``pos`` over copies of the rings
    ``src`` in ``cfg.dtype``, with the kernels and plain; returns
    (max |diff| / max |logit|, the kernel launches).  ``record`` gets
    the plain run's ``decode_attn`` calls as ``(q, k, v, pos, out)``."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as M
    from repro_torch.models.attention import KVCache
    dt = getattr(torch, cfg.dtype)
    out = {}
    plain = attn_mod.decode_attn

    def recording(q, k, v, p, **kw):
        o = plain(q, k, v, p, **kw)
        record.append((q, k, v, p, o))
        return o
    for use in (True, False):
        caches = [KVCache(c.k.to(dt), c.v.to(dt), c.length.clone())
                  for c in src]
        if use:
            reset_counters()
        elif record is not None:
            attn_mod.decode_attn = recording
        try:
            out[use], _ = M.decode_step(params, cfg, tok, pos, caches,
                                        use_kernels=use)
        finally:
            attn_mod.decode_attn = plain
        torch.cuda.synchronize()
        if use:
            launches = counters["decode_attention"].count
    rel = float((out[True] - out[False]).abs().max()) / float(
        out[False].abs().max())
    return rel, launches


def danube_rings(dev, seed: int) -> tuple:
    """h2o-danube-3-4b at full width from ``seed``: (cfg, the generator,
    the weights, every layer's ring (C = 4096) for rows at
    ``RING_POSITIONS`` filled with random values, a token a row, the
    positions), the generator drawing weights, rings and tokens in
    turn."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("h2o-danube-3-4b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen, device=dev)
    B = len(RING_POSITIONS)
    rings = M.init_cache(cfg, B, DANUBE_C_MAX, device=dev)
    for c in rings:
        if c.k.shape[2] != cfg.sliding_window:
            raise AssertionError(f"danube: ring of {c.k.shape[2]} slots, "
                                 f"expected {cfg.sliding_window}")
        for x in (c.k, c.v):
            x.copy_(torch.randn(x.shape, generator=gen, device=dev))
    pos = torch.tensor(RING_POSITIONS, dtype=torch.int32, device=dev)
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev)
    return cfg, gen, params, rings, tok, pos


def danube_path(dev, seed: int, counters, reset_counters) -> dict:
    """14b: h2o-danube-3-4b at full width (24 layers, GQA 32/8, hd 120,
    window 4096, bf16): every layer's ring (C = 4096) filled with random
    bf16 values, one ``decode_step`` of 4 rows at ``RING_POSITIONS`` with
    the kernels and one plain, in float32 (within ``GATE_TOL``, each plain
    layer held to the linear-cache computation) and in bf16 (within
    ``RING_BF16_TOL``), on the same weights; a short serve with c_max =
    8192, whose requests end near position 80, short of the wrap (the
    engine's own writes cross it at smoke size, in
    tests/test_torch_serving.py; a 4097-token prompt would add ~100 s of
    ticks here); one prefill at S = 8192, where the window bites.  Returns
    the path's launches."""
    import torch
    from repro_torch.models import model as M
    cfg, gen, params, rings, tok, pos = danube_rings(dev, seed)
    C, window = cfg.sliding_window, cfg.sliding_window
    print(f"danube: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} GQA {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.resolved_head_dim} window {window}, {cfg.dtype}: "
          f"{param_count(params) / 1e9:.3f} B parameters")
    B = len(RING_POSITIONS)
    calls = []
    cfg32 = cfg.with_(dtype="float32")
    params32 = cast_params(params, torch.float32)
    rel32, n32 = ring_step(cfg32, params32, rings, tok, pos, counters,
                           reset_counters, record=calls)
    worst = ring_linear_check(calls, C, window, gen)
    del params32, calls
    torch.cuda.empty_cache()
    rel16, n16 = ring_step(cfg, params, rings, tok, pos, counters,
                           reset_counters)
    n_dec = n32 + n16
    print(f"danube ring decode: B={B} at positions {RING_POSITIONS} (ring "
          f"C={C}, window {window}, random bf16 rings): logits with kernels "
          f"vs plain max |diff| / max |logit| {rel32:.4g} in float32 (gate "
          f"{GATE_TOL['float32']:g}), {rel16:.4g} in bf16 (limit "
          f"{RING_BF16_TOL:g}); each of {cfg.num_layers} float32 plain "
          f"layers equals the linear {int(pos.max()) + 1}-slot cache "
          f"through the window mask, max abs err {worst:.3g} (tol 2e-5); "
          f"decode_attention launches {n32} + {n16}")
    if n32 != cfg.num_layers or n16 != cfg.num_layers:
        raise AssertionError(f"danube ring: {n32} and {n16} decode "
                             f"launches, expected {cfg.num_layers} each")
    if not rel32 <= GATE_TOL["float32"] or not rel16 <= RING_BF16_TOL:
        raise AssertionError("danube ring decode: kernels vs plain over "
                             "the gate")
    del rings
    torch.cuda.empty_cache()

    engine, decode_s = timed_engine(cfg, params, dev, num_replicas=1,
                                    c_max=DANUBE_C_MAX)
    rng = np.random.default_rng(seed + 1)
    launches = serve_and_count(
        f"danube serve (c_max {DANUBE_C_MAX})", cfg, engine, decode_s,
        short_requests(rng, cfg.vocab_size, 6, (32, 64), (8, 16)), counters,
        reset_counters, cfg.num_layers)
    launches["decode_attention"] += n_dec
    del engine
    long_prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (1, DANUBE_C_MAX)).astype(np.int64)).to(dev)
    reset_counters()
    out = M.prefill(params, cfg, tokens=long_prompt)
    torch.cuda.synchronize()
    flash = counters["flash_attention"].count
    if flash != cfg.num_layers or out.shape != (1, cfg.vocab_size) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"danube prefill: flash launches {flash} "
                             f"(expected {cfg.num_layers}) or bad logits")
    launches["flash_attention"] = flash
    prefill_ms = time_ms(lambda: M.prefill(params, cfg, tokens=long_prompt),
                         3)
    print(f"danube: prefill S={DANUBE_C_MAX} (window {window}) "
          f"{prefill_ms:.1f} ms "
          f"(CUDA events, mean of 3), flash_attention launches {flash}; "
          f"the attention alone against SDPA at the same mask: phase 14c")
    del params
    torch.cuda.empty_cache()
    return launches


def new_shapes_phase(dev, seed: int) -> tuple[dict, dict]:
    """14c: decode and flash at this phase's shapes (``DECODE_SHAPES`` and
    ``FLASH_SHAPES`` "mla", "ring" and "swa"), each through
    ``attention_row``.  Returns the decode and flash rows' sub-keys,
    suffixed ``_<shape>``."""
    out = []
    for kernel, tags in (("decode_attention", ("mla", "ring")),
                         ("flash_attention", ("mla", "swa"))):
        row = {}
        for tag in tags:
            r = shape_row(kernel, tag, attention_inputs(dev, seed, kernel,
                                                        tag))
            row.update({f"{key}_{tag}": r[key] for key in ROW_KEYS})
        out.append(row)
    return out[0], out[1]


#: 15a's shapes of the flash backward, causal: (B, H, KV, S, hd, hd_v,
#: window, dtypes).  "llama" is 15b's microbatch at llama3-8b's width,
#: "10m" 15c's batch at examples/train_small.py's model_10m, "swa"
#: h2o-danube-3-4b's window, "mla" deepseek-v2-lite-16b's widths.
BWD_SHAPES = {
    "llama": (2, 32, 8, 2048, 128, 128, 0, ("bfloat16", "float32")),
    "10m": (8, 8, 4, 256, 32, 32, 0, ("bfloat16", "float32")),
    "swa": (1, 32, 8, 8192, 120, 120, 4096, ("bfloat16",)),
    "mla": (1, 16, 16, 2048, 192, 128, 0, ("bfloat16",))}

#: Limits of 15a's backward checks: the largest over dq, dk and dv of max
#: |diff| / max |ref| of a row (``grad_rel_errs``), the kernel against the
#: plain version's float32 gradients on the same inputs.  Readings of
#: tools/attention_margins.py --backward on every shape, seeds 0-2
#: (PERF.md, section 6): sound bf16 0.0056-0.0076 on the tensor cores (P
#: and dS rounded to bf16 besides the gradients) and 0.0039 on the CUDA
#: cores (one rounding), float32 1.8e-6-5.1e-5; with the backward's
#: softmax scale off by 0.5%, 0.0259 and more in either type and instance
#: (off by 1% either way: 0.0497 and more).
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}

#: Limits of 15b's gradient gate at llama3-8b's width (4 layers): per
#: parameter, max |diff| / max |grad| of the kernel path's gradients
#: against the plain attention's on the same card.  float32 decides:
#: sound 1.5e-6-2.2e-6 on seeds 0-2, the backward's scale off by 0.5%
#: 0.0177, by 1% 0.0345 and more (tools/attention_margins.py --backward;
#: 0.0082 and 0.0164 while the backward recomputed its log-sum-exp at the
#: faulty scale).  bf16 is a sanity check: four layers of bf16 rounding
#: read 0.019-0.075 with sound kernels and the same with the faults, while
#: a dropped gradient reads 1.
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.15}

#: Limit of 15a's log-sum-exp check: max |lse - plain| (natural log, so
#: it is the relative error it puts on every P of the row) of the forward
#: kernel's saved log-sum-exp against ``attention_lse_ref`` on the float32
#: copies of the same inputs, either instance.  tools/attention_margins.py
#: --backward, every shape, seeds 0-2 (PERF.md, section 6): sound
#: 4.8e-7-1.9e-6; with the forward's softmax scale off by 0.5%, 0.0138 and
#: more.
LSE_TOL = 1e-4

#: 15a's row keys: ``ROW_KEYS`` (``ms`` eager calls, as SDPA's are timed;
#: ``library_ms`` SDPA's backward alone, its forward outside the window),
#: SDPA's forward and backward together, the kernel's device time (a CUDA
#: graph of calls, no host issue), the log-sum-exp reading and the
#: instance that ran.
BWD_ROW_KEYS = ROW_KEYS + ("library_fwd_bwd_ms", "device_ms", "lse_err",
                           "instance")

#: 15b: llama3-8b's depth cut from 32 layers (1.92 B parameters, ~31 GB
#: of float32 masters, gradients and moments; all 32 would be ~128 GB).
TRAIN_LAYERS = 4


def grad_rel_errs(got, ref) -> tuple[float, float]:
    """``rel_errs`` over a gradient's rows whose reference is not zero: a
    query row that sees one key has a constant softmax, so its dq is zero
    in exact arithmetic and only roundoff is left to divide by (such rows,
    at most 1e-6 of the tensor's max, are read by the whole-tensor
    reading alone)."""
    a, b = (x.double().reshape(-1, x.shape[-1]) for x in (got, ref))
    top = float(b.abs().max())
    rows = b.abs().amax(-1) > 1e-6 * top
    per_row = rel_errs(a[rows], b[rows])[0] if bool(rows.any()) else 0.0
    return per_row, float((a - b).abs().max()) / max(top, 1e-30)


def bwd_inputs(dev, seed: int, tag: str, dtype):
    """q, k, v, dout standard normal from numpy's generator on (seed, tag),
    in ``dtype`` on the card, and the output of the plain forward rounded
    to ``dtype`` (the kernel and the plain backward both read it)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, H, KV, S, hd, hd_v, window, _ = BWD_SHAPES[tag]
    rng = np.random.default_rng([seed, 2, list(BWD_SHAPES).index(tag)])
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device=dev, dtype=dtype) for s in (
        (B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v), (B, H, S, hd_v)))
    out = attention_ref(q, k, v, causal=True, window=window)
    return q, k, v, out, dout


def kernel_lse(inputs, window: int) -> tuple:
    """The forward kernel's saved log-sum-exp on ``inputs`` (causal, at
    ``window``), the instance that wrote it, and its max |diff| from
    ``attention_lse_ref`` on the float32 copies."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    q, k, v = inputs[:3]
    _, lse = fa._forward(q, k, v, True, window)
    _, ref = attention_lse_ref(q.float(), k.float(), v.float(), causal=True,
                               window=window)
    return lse, fa.instance(q.dtype, q.shape[3]), float(
        (lse - ref).abs().max())


def bwd_work(inputs, window: int) -> tuple[int, int]:
    """Bytes the backward must move (q, k, v, out and dout read once; dq,
    dk and dv written once) and its products' operations over the visible
    (query, key) pairs: q k^T, dS K and dS^T Q at 2 hd each, dO V^T and
    P^T dO at 2 hd_v, a pair and query head."""
    q, k, v = inputs[:3]
    B, H, S, hd = q.shape
    KV, hd_v = k.shape[1], v.shape[3]
    elems = 2 * (B * H * S * hd + B * KV * S * (hd + hd_v)) \
        + 2 * B * H * S * hd_v
    pairs = B * sum(min(i + 1, window) if window else i + 1
                    for i in range(S))
    return q.element_size() * elems, 2 * (3 * hd + 2 * hd_v) * H * pairs


def bwd_check(tag: str, dtype: str, inputs, window: int) -> dict:
    """The forward kernel's log-sum-exp on ``inputs`` against its plain
    version (``LSE_TOL``); the backward kernel fed it against
    ``attention_bwd_ref`` on the float32 copies (``BWD_TOL``), two calls
    equal bit for bit; then times the kernel and the plain version (CUDA
    events after a warm-up), SDPA's backward alone and its forward and
    backward at the same mask (the yardsticks, never on the path), and
    takes the bound.  Prints one line; returns the readings and times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v, out, dout = inputs
    kw = dict(causal=True, window=window)
    lse, inst, lse_err = kernel_lse(inputs, window)
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {tag} {dtype} ({inst}): the "
                             f"saved log-sum-exp is {lse_err:.4g} off the "
                             f"plain one (limit {LSE_TOL:g})")
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {tag} {dtype}: two calls "
                             "on the same inputs differ")
    ref = attention_bwd_ref(*(x.float() for x in inputs), **kw)
    reads = [grad_rel_errs(a, b) for a, b in zip(got, ref)]
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, ref))
    rel = max(r[0] for r in reads)
    del again, ref
    if not rel <= BWD_TOL[dtype]:
        raise AssertionError(f"flash_attention_bwd {tag} {dtype}: max |diff| "
                             f"/ max |ref| of a row {rel:.4g} over "
                             f"{BWD_TOL[dtype]:g}")
    ms = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                     lse, **kw), 3)
    dev_ms = device_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, dout, lse, **kw), 3)
    plain_ms = time_ms(lambda: attention_bwd_ref(*inputs, **kw), 1)
    S = q.shape[2]
    if window:
        i = torch.arange(S, device=q.device)
        mask = dict(attn_mask=(i[None] <= i[:, None])
                    & (i[None] > i[:, None] - window))
    else:
        mask = dict(is_causal=True)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def sdpa():
        o = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **mask)
        torch.autograd.grad(o, leaves, dout)
    both_ms = time_ms(sdpa, 3)
    o = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, leaves, dout,
                                                 retain_graph=True), 3)
    del o
    nbytes, ops = bwd_work(inputs, window)
    b_ms, b_by = bound(nbytes, ops, BF16_TC_OPS_PER_S
                       if dtype == "bfloat16" else FP32_OPS_PER_S)
    B, H, _, hd = q.shape
    print(f"flash_attention_bwd {tag} B={B} H={H} KV={k.shape[1]} S={S} "
          f"hd={hd} hd_v={v.shape[3]} window={window} {dtype} ({inst} "
          f"instance): forward log-sum-exp max |diff| {lse_err:.3g} (limit "
          f"{LSE_TOL:g}); max |diff| / max |ref| of a row (dq, dk, dv) "
          f"{', '.join(f'{r[0]:.4g}' for r in reads)} (limit "
          f"{BWD_TOL[dtype]:g}), over the whole tensor "
          f"{', '.join(f'{r[1]:.4g}' for r in reads)}; max abs err "
          f"{err:.3g}; two calls equal; kernel {ms:.3f} ms ({ops / ms / 1e9:.1f}"
          f" TFLOP/s; device time of a graph of calls {dev_ms:.3f} ms), "
          f"plain {plain_ms:.2f} ms, library (SDPA, "
          f"{'boolean mask' if window else 'is_causal'}) backward alone "
          f"{lib_ms:.3f} ms, forward and backward {both_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {nbytes:.4g} B, {ops:.4g} operations)",
          flush=True)
    return dict(max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_fwd_bwd_ms=both_ms, device_ms=dev_ms, lse_err=lse_err,
                instance=inst)


def bwd_phase(dev, seed: int) -> dict:
    """15a: the tensor-core instructions of the backward's tensor-core
    instances, then the flash backward kernel against its plain version
    at every ``BWD_SHAPES`` shape and dtype; the row's keys from llama's
    bf16 shape, the others' under suffixed keys (``ms_llama_float32``,
    ...)."""
    import torch
    row = {"tensor_cores": tensor_core_check(
        "flash_attention_bwd", ("dq_tc_kernel", "dkv_tc_kernel"))}
    print(f"flash_attention_bwd tensor-core instances: HGMMA/HMMA per "
          f"instance {row['tensor_cores']}", flush=True)
    for tag, shape in BWD_SHAPES.items():
        for dtype in shape[-1]:
            r = bwd_check(tag, dtype, bwd_inputs(dev, seed, tag,
                                                 getattr(torch, dtype)),
                          shape[6])
            torch.cuda.empty_cache()
            if tag == "llama" and dtype == "bfloat16":
                row.update((k, r[k]) for k in BWD_ROW_KEYS)
            else:
                row.update((f"{k}_{tag}_{dtype}", r[k])
                           for k in BWD_ROW_KEYS)
    return row


def train_grad_gate(trainer, params, batch, dtype: str, check: bool = True,
                    tag: str = "15b",
                    limits: dict = TRAIN_GRAD_TOL) -> float:
    """15b's gate (16b's and 16c's with their ``tag`` and ``limits``): the
    loss's gradients through the kernels against the plain versions' on
    ``batch``, per parameter; every parameter must get a finite gradient.
    Returns the largest reading (held to ``limits`` unless ``check`` is
    off)."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    grads = {}
    for use in (True, False):
        loss, g = trainer.loss_and_grad(params, batch, use_kernels=use)
        leaves = tree_leaves(g)
        if any(x is None for x in leaves):
            raise AssertionError(f"{tag} {dtype}: a parameter got no "
                                 "gradient "
                                 f"(use_kernels={use})")
        if not all(bool(torch.isfinite(x).all()) for x in leaves):
            raise AssertionError(f"{tag} {dtype}: a gradient is not finite")
        grads[use] = (float(loss), leaves)
    reads = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for a, b in zip(grads[True][1], grads[False][1])]
    worst = max(reads)
    print(f"{tag} gradient gate {dtype}: loss {grads[True][0]:.6f} with the "
          f"kernels, {grads[False][0]:.6f} plain; per parameter max |diff| / "
          f"max |grad| largest {worst:.4g}, median "
          f"{float(np.median(reads)):.4g} over {len(reads)} parameters "
          f"(limit {limits[dtype]:g})", flush=True)
    del grads
    torch.cuda.empty_cache()
    if check and not worst <= limits[dtype]:
        raise AssertionError(f"{tag} gradient gate {dtype}: {worst:.4g} "
                             "over "
                             f"{limits[dtype]:g}")
    return worst


def train_gates(dev, seed: int, layers: int = TRAIN_LAYERS,
                check: bool = True) -> tuple:
    """llama3-8b at full width and ``layers`` layers, float32 masters from
    ``seed``, and its trainer (15b's configuration); with the gradient
    gate on the first microbatch of step 1's batch in bf16 and float32.
    Returns (cfg, tcfg, trainer, params, readings)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model, device_put_batch
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("llama3-8b").with_(num_layers=layers)
    tcfg = TrainerConfig(seq_len=2048, global_batch=4, microbatches=2,
                         steps=4, ckpt_every=0, log_every=1)
    trainer = Trainer(cfg, tcfg, device=dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev, param_dtype=torch.float32)
    batch = device_put_batch(batch_for_model(cfg, trainer.dcfg, 0), dev)
    micro = {k: v[:tcfg.global_batch // tcfg.microbatches]
             for k, v in batch.items()}
    reads = {}
    for dtype in ("bfloat16", "float32"):
        gate = Trainer(cfg.with_(dtype=dtype), tcfg, device=dev)
        reads[dtype] = train_grad_gate(gate, params, micro, dtype, check)
    return cfg, tcfg, trainer, params, reads


def train_path(dev, seed: int, counters, reset_counters) -> dict:
    """15b: llama3-8b at full width, depth cut to ``TRAIN_LAYERS``, bf16
    compute on float32 masters: the gradient gate, then ``Trainer.run``
    for 4 steps of 2 microbatches x 2 rows x 2048 tokens with exact flash
    launch counts (a forward, its remat re-run and two backward launches
    a layer and microbatch), a profile of one step, and the trained
    weights cast to bf16 and served.  Returns the path's launches."""
    import torch
    from repro_torch.data.pipeline import batch_for_model, device_put_batch
    from repro_torch.train.trainer import TrainState
    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg, trainer, params, _ = train_gates(dev, seed)
    n = param_count(params)
    print(f"15b: llama3-8b d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_layers} of 32 "
          f"layers: {n / 1e9:.3f} B parameters, float32 masters, bf16 "
          f"compute, remat {cfg.remat_policy}", flush=True)
    state = TrainState(params, trainer.optimizer.init(params))
    del params
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: c.count for k, c in counters.items()}
    hist, secs = state.metrics["loss_history"], state.metrics["step_seconds"]
    steps, micro = tcfg.steps, tcfg.microbatches
    want = {"flash_attention": 2 * cfg.num_layers * micro * steps,
            "flash_attention_bwd": 2 * cfg.num_layers * micro * steps}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"15b: launches {launches}, expected {want} "
                             "and nothing else")
    if not all(np.isfinite(hist)):
        raise AssertionError(f"15b: a loss is not finite: {hist}")
    tokens = tcfg.global_batch * tcfg.seq_len
    steady = float(np.mean(secs[1:]))
    print(f"15b: Trainer.run {steps} steps of {tokens} tokens ({micro} "
          f"microbatches of {tcfg.global_batch // micro} x {tcfg.seq_len}) in "
          f"{wall:.2f} s; losses {', '.join(f'{x:.4f}' for x in hist)}; step "
          f"ms {', '.join(f'{x * 1e3:.1f}' for x in secs)} (host clock, "
          f"synchronised; steps 2-{steps} mean {steady * 1e3:.1f} ms, "
          f"{tokens / steady:.0f} tokens/s); peak {peak:.2f} GB "
          f"(max_memory_allocated); launches flash_attention "
          f"{launches['flash_attention']}, flash_attention_bwd "
          f"{launches['flash_attention_bwd']}", flush=True)
    batch = device_put_batch(batch_for_model(cfg, trainer.dcfg, steps), dev)
    trainer.train_step(state.params, state.opt_state, batch)
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        trainer.train_step(state.params, state.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_split("15b train", prof, wall_us, 1, "step", parts={
        "flash forward (with its remat re-run)": ("flash_attention_tc_kernel",
                                                  "flash_attention_kernel"),
        "flash backward (dq and dk/dv)": ("bwd_tc::", "bwd::")})
    del prof, batch
    served = cast_params(state.params, torch.bfloat16)
    del state
    torch.cuda.empty_cache()
    engine, decode_s = timed_engine(cfg, served, dev, num_replicas=1,
                                    c_max=256)
    reqs = short_requests(np.random.default_rng(seed), cfg.vocab_size, 6,
                          (24, 64), (4, 12))
    serve_and_count("15b serve of the trained weights", cfg, engine,
                    decode_s, reqs, counters, reset_counters,
                    cfg.num_layers)
    del engine, served
    torch.cuda.empty_cache()
    return launches


def model_10m():
    """examples/train_small.py's ``model_10m`` (a LLaMA-style 4-layer
    model, d_model 256, 8/4 heads of 32, d_ff 1024, vocab 4096)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="llama-10m", family="dense", num_layers=4,
                       d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                       vocab_size=4096, head_dim=32)


def small_path(dev, counters, reset_counters, steps: int = 60,
               preempt: int = 36, every: int = 12) -> dict:
    """15c: ``model_10m`` trained ``steps`` steps at seq_len 256, global
    batch 8 (examples/train_small.py's settings), with deterministic
    algorithms on; the mean loss of the last 5 steps must be under 0.9 x
    the first 5 (tests/test_system.py:27).  A second run is preempted at
    step ``preempt`` with checkpoints every ``every`` steps and resumed:
    its parameters, moments and losses must equal the uninterrupted run's
    bit for bit.  Returns the uninterrupted run's launches."""
    import tempfile

    import torch
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import (PreemptionError, Trainer,
                                           TrainerConfig)
    cfg = model_10m()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            def trainer(tag, **kw):
                return Trainer(cfg, TrainerConfig(
                    seq_len=256, global_batch=8, steps=steps,
                    ckpt_every=every, ckpt_dir=f"{tmp}/{tag}", log_every=20,
                    peak_lr=6e-4, warmup=20, **kw), device=dev)
            t = trainer("ref")
            state = t.init_state()
            print(f"15c: {cfg.name}, {param_count(state.params) / 1e6:.2f} M "
                  f"parameters", flush=True)
            reset_counters()
            t0 = time.perf_counter()
            ref = t.run(state)
            wall = time.perf_counter() - t0
            launches = {k: c.count for k, c in counters.items()}
            want = {"flash_attention": 2 * cfg.num_layers * steps,
                    "flash_attention_bwd": 2 * cfg.num_layers * steps}
            if any(launches[k] != want.get(k, 0) for k in launches):
                raise AssertionError(f"15c: launches {launches}, expected "
                                     f"{want} and nothing else")
            hist = ref.metrics["loss_history"]
            first, last = np.mean(hist[:5]), np.mean(hist[-5:])
            print(f"15c: {steps} steps in {wall:.2f} s (step "
                  f"{np.mean(ref.metrics['step_seconds'][1:]) * 1e3:.1f} ms "
                  f"mean after the first); loss first 5 mean {first:.4f}, last"
                  f" 5 mean {last:.4f} (ratio {last / first:.4f}, limit 0.9)",
                  flush=True)
            if not last < 0.9 * first:
                raise AssertionError("15c: the loss did not fall by 10%")
            t1 = trainer("run", preempt_at_step=preempt)
            try:
                t1.run(t1.init_state())
                raise AssertionError("15c: no preemption")
            except PreemptionError:
                pass
            logs = []
            resumed = trainer("run").run(log=logs.append)
            same = resumed.metrics["loss_history"] == hist[preempt:] and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                    tree_leaves((resumed.params, resumed.opt_state)),
                    tree_leaves((ref.params, ref.opt_state))))
            print(f"15c: preempted at step {preempt} (checkpoints every "
                  f"{every}), {logs[0]!r}; the resumed run's parameters, "
                  f"moments and last {steps - preempt} losses equal the "
                  f"uninterrupted run's bit for bit: {same}", flush=True)
            if not same:
                raise AssertionError("15c: the resumed run differs from the "
                                     "uninterrupted one")
    finally:
        torch.use_deterministic_algorithms(False)
    return launches


#: 16a's shapes of the chunk scan's backward: (B, H, G, nc, Lc, hd, N,
#: kind).  "train" is 16b's microbatch at mamba2-130m's width (S = 4096,
#: the registry's TRAIN_4K length, in 16 chunks of 256) as ``mamba_apply``
#: gives it (float32 x, a and dy as views of the model's layout, bf16 B and
#: C slices of the conv output: the path's instance, the kernels line's
#: row); "float32" the same all float32 and contiguous; "groups" two
#: groups of four heads with hd and N the wrapper pads; "lc1024" the
#: largest chunk, in the model's layout.
SSD_BWD_SHAPES = {
    "train": (4, 24, 1, 16, 256, 64, 128, "model"),
    "float32": (4, 24, 1, 16, 256, 64, 128, "float32"),
    "groups": (2, 8, 2, 8, 256, 62, 126, "float32"),
    "lc1024": (1, 24, 1, 4, 1024, 64, 128, "model")}

#: Limits of 16a, per gradient tensor as max |diff| / max |grad| against
#: the plain backward on float32 copies (and against autograd of the
#: chunked form in float64).  tools/ssd_margins.py on seeds 0-2 (PERF.md,
#: section 6): sound float32 gradients read at most 6.8e-6; dB and dC that
#: come back in bf16 (rounded from float32, so at most one bf16 step,
#: 2^-7, off) 0.0017-0.0032.  With no reverse state pass dx, dB and da
#: read 0.16 and more (dB in bf16 too); with dcs shifted a row, da 0.94
#: and more.
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

#: Limits of 16b's and 16c's gradient gates: per parameter, max |diff| /
#: max |grad| of the gradients through the kernels against the plain
#: chunked form's (``use_kernels=False``) on the same card.  float32
#: decides: at mamba2-130m's full width and depth sound runs read
#: 3.5e-5-4.2e-5 on seeds 0-2, and either planted fault of
#: tools/ssd_margins.py 0.54 and more.  bf16: 24 layers of bf16 rounding
#: read 0.094-0.114 sound and 0.56 and more with a fault, so the limit
#: sits between, ~2.2x from each (PERF.md, section 6).
MAMBA_TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.25}


def ssd_bwd_work(B, H, G, nc, Lc, hd, N, bc_size=4) -> tuple[float, float,
                                                              float]:
    """Bytes and operations of the chunk scan's backward, and the TF32
    tensor-core operations its products take in split TF32.  Bytes: x,
    a, dy, B and C read once, dx, da, dB and dC written once.  Operations
    per chunk and head over the causal pairs (as ``ssd_work``): the scores
    C B^T and dy x^T, Lc (Lc + 1) N and Lc (Lc + 1) hd; P dy into dx, P' C
    into dB and P' B into dC, Lc (Lc + 1) hd, N and N; and the four (hd x
    N) state products (dS, and the state terms of dx, dB and dC), 2 Lc hd
    N each.  TF32: three mma a product in split TF32, fewer where B or C
    are bf16 (exact in TF32, no lo part): C B^T one, P' C, P' B and the
    state term of dx two."""
    S = nc * Lc
    nbytes = 4 * B * S * H * (3 * hd + 2) + 4 * bc_size * B * S * G * N
    pairs = B * H * nc * Lc * (Lc + 1)
    state = B * H * nc * 2 * Lc * hd * N
    scores_cb, scores_gx = pairs * N, pairs * hd
    dx_p, db_p, dc_p = pairs * hd, pairs * N, pairs * N
    ops = scores_cb + scores_gx + dx_p + db_p + dc_p + 4 * state
    if bc_size == 4:
        tf32 = 3 * ops
    else:
        tf32 = scores_cb + 3 * scores_gx + 3 * dx_p + 2 * (db_p + dc_p) \
            + (3 + 2 + 3 + 3) * state
    return nbytes, ops, tf32


def ssd_bwd_inputs(dev, seed: int, tag: str):
    """16a's inputs at ``SSD_BWD_SHAPES[tag]`` from numpy's generator on
    (seed, tag): the leaves (x, B and C, a, dy) and a function giving the
    kernel's views of them, (B, H or G, nc, Lc, *), and dy's."""
    import torch
    import torch.nn.functional as F
    B, H, G, nc, Lc, hd, N, kind = SSD_BWD_SHAPES[tag]
    S = nc * Lc
    rng = np.random.default_rng([seed, 3, list(SSD_BWD_SHAPES).index(tag)])

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    x, a, dy = normal(B, S, H, hd) * 0.5, -F.softplus(normal(B, S, H)), \
        normal(B, S, H, hd)
    bc = normal(B, S, 2 * G * N) * 0.5
    if kind == "model":
        bc = bc.to(torch.bfloat16)

    def views(x, bc, a, dy):
        def heads(t):
            return t.reshape(B, nc, Lc, H, -1).permute(0, 3, 1, 2, 4)

        def groups(t):
            return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
        out = (heads(x), groups(bc[..., :G * N]), groups(bc[..., G * N:]),
               a.reshape(B, nc, Lc, H).permute(0, 3, 1, 2), heads(dy))
        if kind == "model":
            return out
        return tuple(t.contiguous() for t in out)
    return (x, bc, a, dy), views


def ssd_bwd_check(tag: str, dev, seed: int, with_times: bool) -> dict:
    """16a at one shape: the gradients through ``SSDScan`` (the forward's
    three launches, then the backward's ``LAUNCHES_PER_BWD``) against
    ``ssd_bwd_ref`` on float32 copies and against ``torch.autograd`` of
    the plain chunked form (``ssd_chunk_scan``) in float64, per tensor
    within ``SSD_BWD_TOL``; two calls equal bit for bit; with
    ``with_times``, each backward stage kernel against its plain stage,
    the device times of the call and of each launch (CUDA events after a
    warm-up), the plain version's, and the bound.  Prints its lines;
    returns the readings and times."""
    import torch
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.mamba2 import ssd_chunk_scan
    B, H, G, nc, Lc, hd, N, kind = SSD_BWD_SHAPES[tag]
    leaves, views = ssd_bwd_inputs(dev, seed, tag)
    x, b, c, a, g = views(*leaves)

    def through_kernels():
        args = [t.detach().requires_grad_() for t in (x, b, c, a)]
        before = sk.bwd_launches.count
        y = sk.ssd_scan_cuda(*args)
        grads = torch.autograd.grad(y, args, g)
        if sk.bwd_launches.count != before + sk.LAUNCHES_PER_BWD:
            raise AssertionError(f"ssd_scan_bwd {tag}: "
                                 f"{sk.bwd_launches.count - before} launches,"
                                 f" expected {sk.LAUNCHES_PER_BWD}")
        return grads
    got = through_kernels()
    again = through_kernels()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"ssd_scan_bwd {tag}: two calls on the same "
                             "inputs differ")
    del again
    f32 = [t.detach().float() for t in (x, b, c, a)]
    starts = sref.state_pass_ref(*sref.chunk_states_ref(f32[0], f32[1],
                                                        f32[3]))
    ref = sref.ssd_bwd_ref(*f32, starts, g)
    leaves64 = [t.double().requires_grad_() for t in f32]
    hpg = H // G

    def chunked(x, b, c, a):
        def lay(t):                                   # heads after Lc
            return t.movedim(1, 3)
        y, _ = ssd_chunk_scan(
            lay(x), lay(b.repeat_interleave(hpg, 1)),
            lay(c.repeat_interleave(hpg, 1)), lay(a),
            torch.zeros((B, H, hd, N), dtype=torch.float64, device=dev))
        return y.movedim(3, 1)
    form = torch.autograd.grad(chunked(*leaves64), leaves64, g.double())
    del leaves64
    names = ("dx", "dB", "dC", "da")
    reads, errs = {}, []
    for name, gk, r, r64 in zip(names, got, ref, form):
        dtype = "bfloat16" if gk.dtype == torch.bfloat16 else "float32"
        rd = [float((gk.double() - w.double()).abs().max())
              / max(float(w.abs().max()), 1e-30) for w in (r, r64)]
        errs.append(float((gk.double() - r.double()).abs().max()))
        reads[name] = (rd[0], rd[1], dtype)
        if not max(rd) <= SSD_BWD_TOL[dtype]:
            raise AssertionError(
                f"ssd_scan_bwd {tag} {name} ({dtype}): max |diff| / max "
                f"|grad| {rd[0]:.4g} against the plain backward, {rd[1]:.4g} "
                f"against the chunked form, over {SSD_BWD_TOL[dtype]:g}")
    line = (f"ssd_scan_bwd {tag} B={B} H={H} G={G} nc={nc} Lc={Lc} hd={hd} "
            f"N={N} ({'model layout, bf16 B C' if kind == 'model' else kind}"
            f"): max |diff| / max |grad| against the plain backward and the "
            f"float64 chunked form: " + ", ".join(
                f"{n} {r[0]:.3g} / {r[1]:.3g} ({r[2]}, limit "
                f"{SSD_BWD_TOL[r[2]]:g})" for n, r in reads.items())
            + "; two calls equal")
    row = dict(max_abs_err=max(errs), reads=reads)
    if not with_times:
        print(line, flush=True)
        return row
    y, saved = sk._scan(x, b, c, a)
    xp, bp, cp, ap, st, tot, out = saved
    gp = sk.operand(g.float(), xp.shape[-1])
    ms = time_ms(lambda: sk.ssd_scan_bwd_cuda(xp, bp, cp, ap, gp, out, st,
                                              tot), 10)
    plain_ms = time_ms(lambda: sref.ssd_bwd_ref(*f32, starts, g), 1)
    stage_ms = ssd_bwd_stages(tag, xp, bp, cp, ap, gp, out, st, tot)
    nbytes, ops, tf32 = ssd_bwd_work(B, H, G, nc, Lc, hd, N,
                                     b.element_size())
    b_ms, b_by = bound(nbytes, tf32, TF32_TC_OPS_PER_S)
    stages = ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
    print(line + f"; call {ms:.4f} ms ({stages}), plain "
          f"{plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e9:.3f} GB = {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms;"
          f" {tf32 / 1e9:.1f} GFLOP of TF32 products for {ops / 1e9:.1f} "
          f"GFLOP at {TF32_TC_OPS_PER_S:.3g}/s = "
          f"{tf32 / TF32_TC_OPS_PER_S * 1e3:.4f} ms); {ms / b_ms:.1f}x the "
          "bound", flush=True)
    return dict(row, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                stage_ms=stage_ms)


def ssd_bwd_stages(tag: str, x, b, c, a, g, y, starts, totals) -> dict:
    """Each backward stage kernel against its plain stage on the same
    padded operands (within 1e-4 of its max), and its time (CUDA events,
    mean of 10 calls after a warm-up)."""
    import torch
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    G, N = b.shape[1], b.shape[-1]
    states, _ = sref.chunk_states_ref(x, b, a)

    def close(what, got, want):
        err = float((got.double() - want.double()).abs().max())
        if not err <= 1e-4 * float(want.abs().max()):
            raise AssertionError(f"ssd_scan_bwd {tag} {what}: max abs err "
                                 f"{err:.3g} against the plain stage")
    dS = sk.chunk_dstates_cuda(g, c, a)
    want_dS = sref.chunk_dstates_ref(g, c, a)
    close("chunk_dstates", dS, want_dS)
    Q, dT = sref.state_pass_bwd_ref(want_dS, starts, totals)
    end = dT + (Q * states).sum((-2, -1))
    q, e = sk.state_pass_bwd_cuda(want_dS.clone(), starts, totals)
    close("state_pass_bwd Q", q, Q)
    close("state_pass_bwd end", e, end)
    got = sk.chunk_scan_bwd_cuda(x, b, c, a, g, y, starts, Q, end)
    want = sref.chunk_scan_bwd_ref(x, b, c, a, starts, Q, dT, g)
    for what, gk, w in zip(("dx", "dB", "dC", "da"), got, want):
        close(f"chunk_scan_bwd {what}", gk[..., :w.shape[-1]], w)
    dB, dC = sk.group_sum_cuda(got[1], got[2], G, N, torch.float32)
    close("group_sum dB", dB, sref.group_sum_ref(want[1], G))
    close("group_sum dC", dC, sref.group_sum_ref(want[2], G))
    scratch = want_dS.clone()
    return {
        "chunk_dstates": time_ms(lambda: sk.chunk_dstates_cuda(g, c, a), 10),
        "state_pass_bwd": time_ms(lambda: sk.state_pass_bwd_cuda(
            scratch, starts, totals), 10),
        "chunk_scan_bwd": time_ms(lambda: sk.chunk_scan_bwd_cuda(
            x, b, c, a, g, y, starts, Q, end), 10),
        "group_sum": time_ms(lambda: sk.group_sum_cuda(
            got[1], got[2], G, N, b.dtype), 10)}


def ssd_bwd_phase(dev, seed: int) -> dict:
    """16a: the tensor-core instructions of the backward's stage kernels,
    then ``ssd_bwd_check`` at every ``SSD_BWD_SHAPES`` shape, timed at
    "train" (the row's keys) and "float32" (``float32``-suffixed keys)."""
    import torch
    row = {"tensor_cores": tensor_core_check(
        "ssd_scan_bwd", ("chunk_dstates_kernel", "chunk_scan_bwd_kernel"))}
    print(f"ssd_scan_bwd tensor-core instructions (SASS HMMA) per kernel: "
          f"{row['tensor_cores']}", flush=True)
    for tag in SSD_BWD_SHAPES:
        r = ssd_bwd_check(tag, dev, seed, tag in ("train", "float32"))
        torch.cuda.empty_cache()
        if tag == "train":
            row.update((k, r[k]) for k in ROW_KEYS if k in r)
            row.update(stage_ms=r["stage_ms"], reads=r["reads"])
        else:
            row.update((f"{k}_{tag}", r[k]) for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "stage_ms")
                if k in r)
    return row


def mamba_grad_gate(cfg, tcfg, dev, params, batch, dtype: str,
                    check: bool = True, tag: str = "16b") -> float:
    """16b's and 16c's gate: ``train_grad_gate`` with the chunk scan's
    limits (``MAMBA_TRAIN_GRAD_TOL``) on ``cfg`` in ``dtype``."""
    from repro_torch.train.trainer import Trainer
    gate = Trainer(cfg.with_(dtype=dtype), tcfg, device=dev)
    return train_grad_gate(gate, params, batch, dtype, check,
                           tag=tag, limits=MAMBA_TRAIN_GRAD_TOL)


def mamba_train_gates(dev, seed: int, check: bool = True) -> tuple:
    """mamba2-130m at full width and depth, float32 masters from ``seed``,
    and 16b's trainer; with the gradient gate on the first microbatch of
    step 1's batch in bf16 and float32.  Returns (cfg, tcfg, trainer,
    params, readings)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model, device_put_batch
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("mamba2-130m")
    # TRAIN_4K's length; its global batch of 256 cut to 8 for the run's time
    tcfg = TrainerConfig(seq_len=4096, global_batch=8, microbatches=2,
                         steps=4, ckpt_every=0, log_every=1)
    trainer = Trainer(cfg, tcfg, device=dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev, param_dtype=torch.float32)
    batch = device_put_batch(batch_for_model(cfg, trainer.dcfg, 0), dev)
    micro = {k: v[:tcfg.global_batch // tcfg.microbatches]
             for k, v in batch.items()}
    reads = {dtype: mamba_grad_gate(cfg, tcfg, dev, params, micro, dtype,
                                    check)
             for dtype in ("bfloat16", "float32")}
    return cfg, tcfg, trainer, params, reads


def mamba_step_profile(trainer, state, batch) -> None:
    """The device split of one 16b step under the profiler, the chunk
    scan's forward, its remat re-run and its backward named apart: the
    forward calls are marked by whether autograd is running a backward
    node when they start (the re-run happens inside the backward pass)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    scan, bwd = sk._scan, sk.ssd_scan_bwd_cuda

    def marked_scan(*args):
        rerun = torch._C._current_autograd_node() is not None
        with torch.profiler.record_function(
                "ssd_scan re-run" if rerun else "ssd_scan forward"):
            return scan(*args)

    def marked_bwd(*args):
        with torch.profiler.record_function("ssd_scan backward"):
            return bwd(*args)
    sk._scan, sk.ssd_scan_bwd_cuda = marked_scan, marked_bwd
    try:
        with profiled() as prof:
            t0 = time.perf_counter()
            trainer.train_step(state.params, state.opt_state, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        sk._scan, sk.ssd_scan_bwd_cuda = scan, bwd
    device_split("16b train", prof, wall_us, 1, "step", parts={
        "ssd_scan forward kernels (forward and its remat re-run)": (
            "chunk_states_kernel", "state_pass_kernel", "chunk_scan_kernel"),
        "ssd_scan backward kernels": (
            "chunk_dstates_kernel", "state_pass_bwd_kernel",
            "chunk_scan_bwd_kernel", "group_sum_kernel")},
        ranges=("ssd_scan forward", "ssd_scan re-run", "ssd_scan backward"))


def mamba_train_path(dev, seed: int, counters, reset_counters) -> dict:
    """16b: mamba2-130m at full width and depth (24 layers), bf16 compute
    on float32 masters: the gradient gate, then ``Trainer.run`` for 4
    steps of 2 microbatches x 4 rows x 4096 tokens with exact launch
    counts (a layer and microbatch: the scan's three forward launches,
    their remat re-run and ``LAUNCHES_PER_BWD`` backward launches;
    nothing else), a profile of one step, and the trained weights cast to
    bf16 and served.  Returns the path's launches."""
    import torch
    from repro_torch.data.pipeline import batch_for_model, device_put_batch
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.train.trainer import TrainState
    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg, trainer, params, _ = mamba_train_gates(dev, seed)
    print(f"16b: mamba2-130m d_model {cfg.d_model}, {cfg.ssm_heads} heads "
          f"of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.num_layers} "
          f"layers: {param_count(params) / 1e6:.1f} M parameters, float32 "
          f"masters, bf16 compute, remat {cfg.remat_policy}", flush=True)
    state = TrainState(params, trainer.optimizer.init(params))
    del params
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: c.count for k, c in counters.items()}
    hist, secs = state.metrics["loss_history"], state.metrics["step_seconds"]
    steps, micro = tcfg.steps, tcfg.microbatches
    n = cfg.num_layers * micro * steps
    want = {"ssd_scan": 2 * sk.LAUNCHES_PER_CALL * n,
            "ssd_scan_bwd": sk.LAUNCHES_PER_BWD * n}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"16b: launches {launches}, expected {want} "
                             "and nothing else")
    if not all(np.isfinite(hist)):
        raise AssertionError(f"16b: a loss is not finite: {hist}")
    tokens = tcfg.global_batch * tcfg.seq_len
    steady = float(np.mean(secs[1:]))
    print(f"16b: Trainer.run {steps} steps of {tokens} tokens ({micro} "
          f"microbatches of {tcfg.global_batch // micro} x {tcfg.seq_len}) in "
          f"{wall:.2f} s; losses {', '.join(f'{x:.4f}' for x in hist)}; step "
          f"ms {', '.join(f'{x * 1e3:.1f}' for x in secs)} (host clock, "
          f"synchronised; steps 2-{steps} mean {steady * 1e3:.1f} ms, "
          f"{tokens / steady:.0f} tokens/s); peak {peak:.2f} GB "
          f"(max_memory_allocated); launches ssd_scan "
          f"{launches['ssd_scan']}, ssd_scan_bwd {launches['ssd_scan_bwd']}",
          flush=True)
    batch = device_put_batch(batch_for_model(cfg, trainer.dcfg, steps), dev)
    trainer.train_step(state.params, state.opt_state, batch)
    torch.cuda.synchronize()
    mamba_step_profile(trainer, state, batch)
    del batch
    served = cast_params(state.params, torch.bfloat16)
    del state
    torch.cuda.empty_cache()
    engine, decode_s = timed_engine(cfg, served, dev, num_replicas=1,
                                    c_max=256)
    reqs = short_requests(np.random.default_rng(seed), cfg.vocab_size, 6,
                          (24, 64), (4, 12))
    serve_and_count("16b serve of the trained weights", cfg, engine,
                    decode_s, reqs, counters, reset_counters, 0)
    del engine, served
    torch.cuda.empty_cache()
    return launches


def jamba_train_path(dev, seed: int, counters, reset_counters) -> dict:
    """16c: jamba-1.5-large-398b's smoke config (attention, MoE and Mamba
    with two groups; full width does not fit one card) in float32: the
    gradient gate at ``MAMBA_TRAIN_GRAD_TOL``, then 2 steps of
    ``Trainer.run`` with exact launch counts; returns them."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import batch_for_model, device_put_batch
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_smoke_config("jamba-1.5-large-398b").with_(dtype="float32")
    tcfg = TrainerConfig(seq_len=256, global_batch=4, microbatches=2,
                         steps=2, ckpt_every=0, log_every=1)
    trainer = Trainer(cfg, tcfg, device=dev)
    state = trainer.init_state(seed)
    batch = device_put_batch(batch_for_model(cfg, trainer.dcfg, 0), dev)
    worst = mamba_grad_gate(cfg, tcfg, dev, state.params, {
        k: v[:2] for k, v in batch.items()}, "float32", tag="16c")
    reset_counters()
    state = trainer.run(state)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    kinds = [d[0] for d in M.layer_descs(cfg)]
    mamba = kinds.count("mamba")
    n = tcfg.microbatches * tcfg.steps
    want = {"ssd_scan": 2 * sk.LAUNCHES_PER_CALL * mamba * n,
            "ssd_scan_bwd": sk.LAUNCHES_PER_BWD * mamba * n,
            "flash_attention": 2 * (len(kinds) - mamba) * n,
            "flash_attention_bwd": 2 * (len(kinds) - mamba) * n}
    hist = state.metrics["loss_history"]
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"16c: launches {launches}, expected {want} "
                             "and nothing else")
    if not all(np.isfinite(hist)):
        raise AssertionError(f"16c: a loss is not finite: {hist}")
    print(f"16c: {cfg.name} smoke config ({cfg.num_layers} layers {kinds}, "
          f"d_model {cfg.d_model}, {cfg.ssm_groups} groups, "
          f"{cfg.num_experts} experts), float32: gradient gate {worst:.4g} "
          f"(limit {MAMBA_TRAIN_GRAD_TOL['float32']:g}); {tcfg.steps} steps, "
          f"losses {', '.join(f'{x:.4f}' for x in hist)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import os

    # cuBLAS is deterministic on one stream only with this workspace
    # setting, which must be in place before CUDA starts: phase 15c
    # trains under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # no tuning cache: every launch takes the knobs this script gives it
    # (phase 13c sweeps into a throwaway cache of its own)
    os.environ["REPRO_TORCH_TUNING_CACHE"] = "off"

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
    from repro_torch.kernels.live_admission import live_admission as lk
    warnings.simplefilter("error", GracefulDegradationWarning)
    counters = {"best_fit": bf_kernel.launches,
                "bfjs": bfjs_kernel.launches,
                "bfjs_mr": bfjs_mr_kernel.launches,
                "vqs": vqs_kernel.launches,
                "vqs_bf": vqs_bf_kernel.launches,
                "decode_attention": da.launches,
                "flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches,
                "ssd_scan": sk.launches,
                "ssd_scan_bwd": sk.bwd_launches,
                "live_admission": lk.launches}

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

    # -- 9. serve path: llama3-8b at full width; on its weights, phase 13e's
    # serve behind live and host admission
    live = {}
    launches = serve_path(
        dev, args.seed, counters, reset_counters,
        with_weights=lambda cfg, params: live.update(live_serve(
            cfg, params, dev, args.seed, counters, reset_counters)))
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

    # -- 12. chunked, streaming and supervised paths at the scheduler width
    runtime_phase(dev, args.seed, counters, reset_counters, rows)
    clock.done("12 chunked, streaming and supervised paths")

    # -- 13. fleet runtime: sharding, the tuner, estimate_capacity, live
    # admission (its serve ran in phase 9)
    fleet_phase(dev, args.seed, counters, reset_counters)
    rows["live_admission"] = dict(
        live_kernel_phase(dev, args.seed, counters, reset_counters),
        launches=live["launches"])
    clock.done("13 fleet runtime")
    print(f"phase 13e serve (run inside phase 9): {live['seconds']:.1f} s")

    # -- 14. MLA, MoE and ring decode at full width --------------------------
    for name, n in deepseek_path(dev, args.seed, counters,
                                 reset_counters).items():
        if name in ("decode_attention", "flash_attention"):
            rows[name]["launches_phase_14a"] = n
    clock.done("14a deepseek-v2-lite-16b path")
    for name, n in danube_path(dev, args.seed, counters,
                               reset_counters).items():
        if name in ("decode_attention", "flash_attention"):
            rows[name]["launches_phase_14b"] = n
    clock.done("14b h2o-danube-3-4b ring path")
    dec, fl = new_shapes_phase(dev, args.seed)
    rows["decode_attention"].update(dec)
    rows["flash_attention"].update(fl)
    clock.done("14c attention kernels at the new shapes")

    # -- 15. training on one device: the flash backward kernel, llama3-8b
    # at full width (4 layers) trained and served, the 10M model's loss
    # and a bit-identical resume
    t15 = time.perf_counter()
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:21 "
                 "(its backward: JAX differentiates chunked_attention, "
                 "src/repro/models/attention.py:71, with XLA)",
        **bwd_phase(dev, args.seed))
    clock.done("15a flash backward kernel")
    launches = train_path(dev, args.seed, counters, reset_counters)
    rows["flash_attention_bwd"]["launches"] = launches["flash_attention_bwd"]
    rows["flash_attention"]["launches_phase_15b"] = \
        launches["flash_attention"]
    clock.done("15b llama3-8b training path")
    launches = small_path(dev, counters, reset_counters)
    rows["flash_attention_bwd"]["launches_phase_15c"] = \
        launches["flash_attention_bwd"]
    clock.done("15c 10M model trained, preempted and resumed")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # -- 16. the chunk scan's backward: the kernels against their plain
    # versions, mamba2-130m trained at full width and depth and served,
    # Jamba's shape trained
    t16 = time.perf_counter()
    rows["ssd_scan_bwd"] = dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:22 (its backward: "
                 "JAX differentiates ssd_chunk_scan, "
                 "src/repro/models/mamba2.py:93, with XLA)",
        library_ms=None, **ssd_bwd_phase(dev, args.seed))
    clock.done("16a ssd_scan backward kernels")
    launches = mamba_train_path(dev, args.seed, counters, reset_counters)
    rows["ssd_scan_bwd"]["launches"] = launches["ssd_scan_bwd"]
    rows["ssd_scan"]["launches_phase_16b"] = launches["ssd_scan"]
    clock.done("16b mamba2-130m training path")
    launches = jamba_train_path(dev, args.seed, counters, reset_counters)
    rows["ssd_scan_bwd"]["launches_phase_16c"] = launches["ssd_scan_bwd"]
    rows["ssd_scan"]["launches_phase_16c"] = launches["ssd_scan"]
    clock.done("16c jamba smoke config trained")
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    print(f"chip_smoke: all phases passed in {clock.total():.1f} s")
    order = ("bfjs", "vqs", "vqs_bf", "bfjs_mr", "best_fit",
             "decode_attention", "flash_attention", "flash_attention_bwd",
             "ssd_scan", "ssd_scan_bwd", "live_admission")
    print(json.dumps({"kernels": [rows[k] for k in order], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
