"""Pre-generated randomness streams shared by the engines (torch port of
``repro.core.engine.streams``).

All engine randomness is drawn before the slot loop into ``SchedStreams``:
per-slot arrival counts, job sizes and service durations.  The layout and
dtypes are those of the JAX package — ``n (T,) int32``, ``sizes (T, A_max)
float32`` (``(T, A_max, R)`` for R-resource demand vectors), ``durs (T,
L*K + A_max) int32`` — so streams made by either package run through
either package's engines (``repro_torch.convert``).

The duration stream layout: the LAST ``A_max`` lanes of ``durs[t]`` belong
to the slot's arrivals (consumed by BF-J placements); everything before
them is the sequential-draw region consumed dc-th-placement-first by the
BF-J/S engines' BF-S refills.

``make_streams`` draws with an explicit ``torch.Generator``.  It does not
reproduce the JAX package's threefry bits: runs that must agree with the
JAX engines share streams instead of seeds.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...device import resolve_device

INF_SLOT = 2 ** 31 - 1  # int32 max: departure slot of an empty server slot


class SchedStreams(NamedTuple):
    """Per-slot randomness consumed by the scheduling engines.  Every field
    may carry a leading ensemble axis G."""
    n: torch.Tensor       # (T,) int32 arrival counts, already clipped to A_max
    sizes: torch.Tensor   # (T, A_max) f32 sizes in (0,1]; (T, A_max, R)
    #                       demand vectors for R > 1 resources
    durs: torch.Tensor    # (T, L*K + A_max) int32 geometric service durations
    #: Optional ``(T, L)`` bool server fault plane (True = up); ``None``
    #: means a fault-free cluster.
    up: torch.Tensor | None = None

    @property
    def num_resources(self) -> int:
        """R: 1 for the squeezed single-resource layout."""
        return 1 if self.sizes.ndim == self.durs.ndim \
            else int(self.sizes.shape[-1])


class PolicyResult(NamedTuple):
    """Per-slot trajectory of one simulated cluster (fields and order as in
    the JAX package; batched runs carry a leading G axis)."""
    queue_len: torch.Tensor   # (T,) int32
    occupancy: torch.Tensor   # (T,) f32 occupied capacity (servers);
    #                           (T, R) per resource for bfjs-mr
    departed: torch.Tensor    # (T,) int32 cumulative departures
    dropped: torch.Tensor     # () int32 arrivals dropped by fixed-size buffers
    truncated: torch.Tensor   # () int32 slots where a fixed bound cut the
    #                           policy short (0 == exact)
    # Fault accounting (() int32, zero on fault-free streams;
    # preempted == requeued + lost):
    preempted: torch.Tensor | None = None
    requeued: torch.Tensor | None = None
    lost: torch.Tensor | None = None
    # Streaming and supervision counters of the JAX package; not set by
    # any engine of the port yet.
    chunks_behind: int | None = None
    host_stall_us: float | None = None
    retries: int | None = None
    quarantined: int | None = None
    rollbacks: int | None = None


def _geometric(generator: torch.Generator, mu: float, shape,
               device) -> torch.Tensor:
    """Geometric service durations >= 1 slot, mean ``1/mu`` — the formula of
    the JAX package: ``max(ceil(log(u) / log1p(-mu)), 1)`` with ``u`` uniform
    on ``[1e-7, 1)`` in float32."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u * (1.0 - 1e-7) + 1e-7, 1e-7)
    denom = torch.tensor(math.log1p(-mu), dtype=torch.float32, device=device)
    return torch.clamp_min(torch.ceil(torch.log(u) / denom), 1.0).to(
        torch.int32)


def make_fault_plane(generator: torch.Generator, L: int, horizon: int,
                     fault_rate: float, repair_rate: float,
                     device=None) -> torch.Tensor:
    """Two-state Markov capacity-shock plane: ``(T, L)`` bool, True = up.

    Every server starts up; an up server goes down with probability
    ``fault_rate`` per slot, a down server recovers with probability
    ``repair_rate`` per slot."""
    device = resolve_device(device)
    u = torch.rand((horizon, L), generator=generator, device=device)
    up = torch.empty((horizon, L), dtype=torch.bool, device=device)
    prev = torch.ones(L, dtype=torch.bool, device=device)
    for t in range(horizon):
        prev = torch.where(prev, u[t] >= fault_rate, u[t] < repair_rate)
        up[t] = prev
    return up


def fault_plane_from_events(events, horizon: int, L: int,
                            device=None) -> torch.Tensor:
    """Build a ``(T, L)`` up-plane from ``(slot, server, up)`` events:
    server ``server`` changes to state ``up`` at ``slot`` and keeps it until
    its next event.  Servers start up; events outside ``[0, horizon)`` or
    ``[0, L)`` raise instead of being dropped silently."""
    device = resolve_device(device)
    plane = np.ones((horizon, L), dtype=bool)
    for slot, server, up in sorted(events, key=lambda e: int(e[0])):
        slot, server = int(slot), int(server)
        if not 0 <= slot < horizon:
            raise ValueError(f"fault event at slot {slot} outside horizon "
                             f"[0, {horizon})")
        if not 0 <= server < L:
            raise ValueError(f"fault event for server {server} outside "
                             f"[0, {L})")
        plane[slot:, server] = bool(up)
    return torch.as_tensor(plane, device=device)


def with_fault_plane(streams: SchedStreams, up) -> SchedStreams:
    """Attach an explicit ``(T, L)`` up-plane to existing streams after
    validating the time axis.  The plane moves to the streams' device."""
    up = torch.as_tensor(up, dtype=torch.bool, device=streams.n.device)
    T = int(streams.n.shape[-1])
    if up.ndim != 2 or up.shape[0] != T:
        raise ValueError(
            f"fault plane must be (T={T}, L), got {tuple(up.shape)}")
    return streams._replace(up=up)


def make_streams(generator: torch.Generator, lam: float, mu: float,
                 sampler: Callable, L: int, K: int, A_max: int,
                 horizon: int, device=None, num_resources: int = 1,
                 fault_rate: float = 0.0,
                 repair_rate: float = 1.0) -> SchedStreams:
    """Pre-generate all per-slot randomness for one cluster simulation.

    Counts are ``torch.poisson(lam)`` clipped to ``A_max``; sizes come from
    one bulk call ``sampler(generator, horizon * A_max, device)`` laid out
    slot-major as ``(T, A_max)``, or as ``(T, A_max, R)`` when
    ``num_resources`` R > 1 and the sampler returns ``(n, R)`` demand
    vectors; durations are ``_geometric`` over the full ``L*K + A_max``
    width.  One generator draws all of them in that order, so the counts do
    not depend on R and the durations do.  ``fault_rate > 0``
    attaches a fault plane drawn from the same generator AFTER the job
    streams, so adding faults never perturbs ``n``/``sizes``/``durs``.
    ``generator`` must live on ``device``."""
    device = resolve_device(device)
    if fault_rate < 0 or repair_rate < 0:
        raise ValueError(
            f"fault_rate/repair_rate must be >= 0, got "
            f"({fault_rate}, {repair_rate})")
    rate = torch.full((horizon,), float(lam), device=device)
    n = torch.clamp_max(torch.poisson(rate, generator=generator),
                        A_max).to(torch.int32)
    draws = horizon * A_max
    sizes = sampler(generator, draws, device)
    want = (draws,) if num_resources == 1 else (draws, num_resources)
    if tuple(sizes.shape) != want:
        raise ValueError(
            f"sampler produced sizes of shape {tuple(sizes.shape)} for "
            f"n={draws}, num_resources={num_resources}: expected {want} "
            "(sampler(generator, n, device) must return (n,) for R == 1, "
            "(n, R) otherwise)")
    sizes = sizes.to(torch.float32).reshape(horizon, A_max, *want[1:])
    durs = _geometric(generator, mu, (horizon, L * K + A_max), device)
    up = None if fault_rate == 0.0 else make_fault_plane(
        generator, L=L, horizon=horizon, fault_rate=fault_rate,
        repair_rate=repair_rate, device=device)
    return SchedStreams(n, sizes, durs, up)


def streams_from_trace(trace_or_slots, sizes=None, durations=None, *,
                       horizon: int | None = None, A_max: int | None = None,
                       collapse: bool = True,
                       num_resources: int | None = None,
                       device=None) -> SchedStreams:
    """Build ``SchedStreams`` that replay a workload trace exactly.

    Takes the raw arrays ``(arrival_slots, sizes, durations)`` — ``sizes``
    ``(N,)`` for scalar jobs or ``(N, R)`` for demand vectors — or any
    object with ``arrival_slots`` and ``durations`` attributes plus either
    ``sizes`` or ``cpu`` and ``mem``.  A two-resource trace is collapsed to
    ``max(cpu, mem)`` as the paper does, or kept as ``(T, A_max, 2)`` (cpu,
    mem) demand vectors with ``collapse=False`` (the ``policy="bfjs-mr"``
    path).  As the JAX ``streams_from_trace``: jobs are stably sorted by
    arrival slot, sizes are quantized per resource with
    ``quantize.to_grid`` and stored as the exact grid value ``g / RES``
    (float32 holds it exactly, so the engines' in-loop quantization
    recovers ``g``), and durations are clamped to >= 1 slot.

    The duration plane holds only the per-arrival lanes, ``(T, A_max)``:
    every job's duration travels with the job, the semantics of the VQS and
    bfjs-mr policies.  The BF-J/S engines need a sequential-draw region a
    trace cannot provide and reject these streams.  ``A_max`` defaults to
    the trace's peak arrivals per slot; a smaller ``A_max`` raises instead
    of dropping trace jobs.  ``num_resources`` pins the R the caller
    expects: a trace with another resource count raises, naming both."""
    from ..quantize import RES, to_grid

    if sizes is None or hasattr(trace_or_slots, "arrival_slots"):
        trace = trace_or_slots
        if sizes is not None or durations is not None:
            raise TypeError(
                "pass either a trace object or (arrival_slots, sizes, "
                "durations), not both")
        arrival_slots = trace.arrival_slots
        durations = trace.durations
        if hasattr(trace, "sizes"):
            sizes = trace.sizes
        elif collapse:
            sizes = np.maximum(trace.cpu, trace.mem)
        else:
            sizes = np.stack([trace.cpu, trace.mem], axis=1)
    else:
        arrival_slots = trace_or_slots
    device = resolve_device(device)

    arrival_slots = np.asarray(arrival_slots)
    order = np.argsort(arrival_slots, kind="stable")
    arrival_slots = arrival_slots[order].astype(np.int64)
    sizes = np.asarray(sizes)
    if sizes.ndim not in (1, 2):
        raise ValueError(f"sizes must be (N,) or (N, R), got {sizes.shape}")
    R = 1 if sizes.ndim == 1 else int(sizes.shape[1])
    if num_resources is not None and R != num_resources:
        hint = ""
        if num_resources == 1 and R > 1:
            hint = " (or pass collapse=True)"
        elif R == 1 and num_resources == 2:
            hint = " (or pass collapse=False)"
        raise ValueError(
            f"trace carries R={R} resource plane(s) (sizes shape "
            f"{tuple(sizes.shape)}) but the target workload expects "
            f"num_resources={num_resources}; pass a matching trace"
            f"{hint} instead of broadcasting")
    g = to_grid(sizes[order])
    durations = np.maximum(np.asarray(durations)[order].astype(np.int64), 1)
    if horizon is None:
        if len(arrival_slots) == 0:
            raise ValueError(
                "empty trace and no horizon: pass horizon= explicitly")
        horizon = int(arrival_slots[-1]) + 1

    in_h = (arrival_slots >= 0) & (arrival_slots < horizon)
    counts = np.bincount(arrival_slots[in_h], minlength=horizon)[:horizon]
    peak = int(counts.max()) if len(counts) else 0
    if A_max is None:
        A_max = max(peak, 1)
    elif peak > A_max:
        raise ValueError(
            f"trace has {peak} arrivals in one slot > A_max={A_max}; "
            "raise A_max (streams never drop trace jobs silently)")

    size_shape = (horizon, A_max) if R == 1 else (horizon, A_max, R)
    size_arr = np.zeros(size_shape, dtype=np.float32)
    dur_arr = np.ones((horizon, A_max), dtype=np.int32)
    slot = arrival_slots[in_h]
    # lane[i] = index of job i within its slot (jobs are slot-sorted)
    lane = np.arange(len(slot)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    size_arr[slot, lane] = (g[in_h].astype(np.float64) / RES).astype(
        np.float32)
    dur_arr[slot, lane] = durations[in_h]
    return SchedStreams(torch.as_tensor(counts.astype(np.int32),
                                        device=device),
                        torch.as_tensor(size_arr, device=device),
                        torch.as_tensor(dur_arr, device=device))


def resolve_work_steps(work_steps: int | None, A_max: int) -> int:
    """Default bound of the per-slot placement work lists: enough for every
    landed arrival plus a burst of refills; the ``truncated`` counter
    reports the (rare) slots where this was short."""
    return work_steps if work_steps is not None else A_max + 4
