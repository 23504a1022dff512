"""BF-J/S cluster engines (paper Section IV), torch port of
``repro.core.engine.bfjs``.

Two engines share one trajectory semantics:

  * ``engine="scan"`` — the branch-free slot engine: all randomness comes
    from pre-generated streams, and the per-slot BF-S/BF-J placement nest is
    one bounded work list of masked selects.  It runs batched over a leading
    ensemble axis G (the JAX package's ``vmap``), with a Python loop over
    slots (its ``lax.scan``).  It is also the plain version of the CUDA
    kernel (``kernels/bfjs/ref.py``).
  * ``engine="cuda"`` — the fused slot-step kernel in ``kernels/bfjs``: one
    thread block per ensemble member, the whole state in shared memory.

Both reproduce the JAX package's ``run_bfjs_streams`` bit for bit on shared
streams — queue length, departures and every counter — with occupancy equal
to float32 rounding (it is summed in another order).  The JAX
``"reference"`` engine draws its randomness in-loop from a threefry key and
has no counterpart here yet.

Fixed-capacity redesign (as in the JAX package): the queue is a
``Qcap``-slot buffer and arrivals that find it full are dropped AND COUNTED
(``dropped``); runs whose drop count is nonzero are saturated, not stable.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...device import resolve_device
from .ops import first_empty_positions, row_sum_lr
from .streams import (INF_SLOT, PolicyResult, SchedStreams, make_streams,
                      resolve_work_steps)

BFJSResult = PolicyResult

#: Default bound on fault-driven requeues: a job evicted by a server-down
#: shock re-enters the queue until it has been preempted ``max_requeue``
#: times, then it is counted ``lost``.
DEFAULT_MAX_REQUEUE = 2

ENGINES = ("scan", "cuda")

_REFERENCE_TODO = (
    "the bfjs \"reference\" engine draws its randomness in-loop from a "
    "threefry key and is not ported yet (ROADMAP queue 1: BF-J/S reference "
    "engine); use engine=\"scan\" or engine=\"cuda\"")


class BFJSState(NamedTuple):
    """The complete carry of the scan engine, in the order of the JAX
    package's scan carry (``run_bfjs_streams(..., return_state=True)``).
    Batched runs carry a leading G axis on every field."""
    srv: torch.Tensor        # (L, K) f32 job sizes in servers (0 = empty)
    dep: torch.Tensor        # (L, K) i32 departure slot (INF_SLOT if empty)
    queue: torch.Tensor      # (Qcap,) f32 queued sizes (0 = empty)
    t: torch.Tensor          # () i32 next slot index
    q_cnt: torch.Tensor      # () i32 queued jobs
    dropped: torch.Tensor    # () i32 arrivals dropped by the buffer
    truncated: torch.Tensor  # () i32 slots the work list cut short
    qtry: torch.Tensor       # (Qcap,) i32 retry counts riding with queued jobs
    tries: torch.Tensor      # (L, K) i32 retry counts of resident jobs
    preempted: torch.Tensor  # () i32
    requeued: torch.Tensor   # () i32
    lost: torch.Tensor       # () i32
    up_last: torch.Tensor    # (L,) bool previous slot's fault-plane row


def initial_state(G: int, L: int, K: int, Qcap: int,
                  device) -> BFJSState:
    """Empty cluster, empty queue, slot 0, for G ensemble members."""
    z = torch.zeros(G, dtype=torch.int32, device=device)
    return BFJSState(
        srv=torch.zeros((G, L, K), dtype=torch.float32, device=device),
        dep=torch.full((G, L, K), INF_SLOT, dtype=torch.int32,
                       device=device),
        queue=torch.zeros((G, Qcap), dtype=torch.float32, device=device),
        t=z, q_cnt=z, dropped=z, truncated=z,
        qtry=torch.zeros((G, Qcap), dtype=torch.int32, device=device),
        tries=torch.zeros((G, L, K), dtype=torch.int32, device=device),
        preempted=z, requeued=z, lost=z,
        up_last=torch.ones((G, L), dtype=torch.bool, device=device))


def _scatter_drop(x: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` along the last axis of a (G, Q)
    plane: an index equal to Q means "no write"."""
    pad = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
    pad.scatter_(1, idx, vals)
    return pad[:, :x.shape[1]]


def _preempt_grid(srv, dep, tries, queue, qtry, up_t, max_requeue):
    """Evict every job resident on a down server (batched over G).

    Victims below the retry bound re-enter the queue in row-major
    ``(server, slot)`` order through the same first-empty admission rule as
    arrivals, carrying ``tries + 1``; the rest (bound exhausted, or queue
    full) are lost.  Returns the updated planes plus this slot's
    ``(n_preempted, n_requeued, n_lost)`` counts (G,)."""
    G, Qcap = queue.shape
    victim = (~up_t)[..., None] & (srv > 0.0)
    elig = (victim & (tries < max_requeue)).reshape(G, -1)
    pos, land = first_empty_positions(queue == 0.0, elig)
    at = torch.where(land, pos, Qcap)
    queue = _scatter_drop(queue, at, torch.where(land, srv.reshape(G, -1),
                                                 0.0))
    qtry = _scatter_drop(qtry, at, torch.where(land, tries.reshape(G, -1) + 1,
                                               0).to(torch.int32))
    n_vict = victim.sum((1, 2), dtype=torch.int32)
    n_req = land.sum(1, dtype=torch.int32)
    srv = torch.where(victim, 0.0, srv)
    dep = torch.where(victim, INF_SLOT, dep)
    tries = torch.where(victim, 0, tries)
    return srv, dep, tries, queue, qtry, n_vict, n_req, n_vict - n_req


def _check_sequential_durs(streams: SchedStreams, L: int, K: int,
                           A_max: int) -> None:
    """BF-J/S consumes a ``durs[t, :L*K]`` sequential-draw region that
    trace-built streams lack (their BF-S refills would detach durations
    from job identities), so a narrower duration stream is rejected."""
    width = streams.durs.shape[-1]
    if width != L * K + A_max:
        raise ValueError(
            f"BF-J/S needs a duration stream of width L*K + A_max = "
            f"{L * K + A_max} (sequential-draw region + per-arrival lanes), "
            f"got {width}.  Trace-built streams carry per-arrival durations "
            "only — replay traces through a policy that attaches durations "
            "at arrival (policy=\"vqs\").")


def _batched(streams: SchedStreams) -> SchedStreams:
    return SchedStreams(*(None if x is None else x[None] for x in streams))


def _first(tree):
    return type(tree)(*(x[0] if isinstance(x, torch.Tensor) else x
                        for x in tree))


def run_bfjs_streams(streams: SchedStreams,
                     L: int, K: int, Qcap: int, A_max: int,
                     work_steps: int | None = None,
                     max_requeue: int = DEFAULT_MAX_REQUEUE,
                     state: BFJSState | None = None,
                     return_state: bool = False):
    """Branch-free BF-J/S slot engine over pre-generated streams.

    ``streams`` fields are ``(T, ...)`` for one cluster or ``(G, T, ...)``
    for an ensemble; the result (and the state) has the same leading shape.
    Inside each slot the BF-S refill and BF-J placement passes are one
    bounded work list of ``work_steps`` masked-select steps.  Each step
    performs the BF-S placement for the lowest-index freed server that still
    has a fitting queued job, otherwise it attempts the next landed arrival
    (BF-J).  The list stops early once no member has a step left: the
    remaining steps would change nothing.

    Residuals are exact: a placement recomputes the target row's sum as a
    left-to-right float32 chain (``ops.row_sum_lr``), the order of the JAX
    engine, and feasibility compares ``1 - rowsum``.

    Streams carrying a fault plane (``streams.up``) run the fault-injected
    variant: down servers evict their jobs (``_preempt_grid``), leave every
    placement-feasibility mask, and rejoin the BF-S freed set on recovery.

    ``state=`` / ``return_state=True`` thread the complete carry
    (:class:`BFJSState`): running the horizon in slices, feeding each slice
    the previous slice's returned state, reproduces the straight-through
    trajectory bit for bit.  Per-slice ``departed`` restarts from 0.
    """
    _check_sequential_durs(streams, L, K, A_max)
    single = streams.n.ndim == 1
    if single:
        streams = _batched(streams)
        if state is not None:
            state = BFJSState(*(x[None] for x in state))
    G = streams.n.shape[0]
    if state is None:
        state = initial_state(G, L, K, Qcap, streams.n.device)
    res, state = _scan(streams, L, K, Qcap, A_max,
                       resolve_work_steps(work_steps, A_max), max_requeue,
                       state)
    if single:
        res, state = _first(res), _first(state)
    return (res, state) if return_state else res


def _scan(streams: SchedStreams, L: int, K: int, Qcap: int, A_max: int,
          W: int, max_requeue: int, state: BFJSState):
    n, sizes, durs, up = streams
    G, T = n.shape
    dev = n.device
    faulted = up is not None
    D = L * K + A_max
    LK = L * K
    a_iota = torch.arange(A_max, device=dev)
    l_iota = torch.arange(L, device=dev)
    q_iota = torch.arange(Qcap, device=dev)
    k_iota = torch.arange(K, device=dev)
    g_ar = torch.arange(G, device=dev)
    inf = float("inf")

    # fresh planes: the loop below updates them in place
    (srv, dep, queue, t, q_cnt, dropped, trunc, qtry, tries, preempted,
     requeued, lost, up_last) = (x.clone() for x in state)
    qlen_out = torch.empty((G, T), dtype=torch.int32, device=dev)
    ndep_out = torch.empty((G, T), dtype=torch.int32, device=dev)
    # per-slot row sums; occupancy is summed from them after the loop
    rsum_out = torch.empty((G, T, L), dtype=torch.float32, device=dev)

    for s in range(T):
        n_s, sizes_s, durs_s = n[:, s], sizes[:, s], durs[:, s]
        up_t = up[:, s] if faulted else None

        # 1. departures
        leaving = dep == t[:, None, None]
        freed = leaving.any(-1)
        n_dep = leaving.sum((1, 2), dtype=torch.int32)
        srv = torch.where(leaving, 0.0, srv)
        dep = torch.where(leaving, INF_SLOT, dep)

        # 1b. capacity shocks: evict jobs on down servers, drop down servers
        # from every placement mask, treat recoveries as freed.
        if faulted:
            tries = torch.where(leaving, 0, tries)
            srv, dep, tries, queue, qtry, n_p, n_r, n_l = _preempt_grid(
                srv, dep, tries, queue, qtry, up_t, max_requeue)
            preempted = preempted + n_p
            requeued = requeued + n_r
            lost = lost + n_l
            q_cnt = q_cnt + n_r
            freed = (freed | (up_t & ~up_last)) & up_t
            up_last = up_t
        rsum = row_sum_lr(srv)

        # 2. arrivals -> first empty queue slots (record where they landed)
        pos_a, landed = first_empty_positions(queue == 0.0,
                                              a_iota < n_s[:, None])
        n_landed = landed.sum(1, dtype=torch.int32)
        dropped = dropped + n_s - n_landed
        q_cnt = q_cnt + n_landed
        queue = _scatter_drop(queue, torch.where(landed, pos_a, Qcap),
                              torch.where(landed, sizes_s, 0.0))
        new_pos = torch.where(landed, pos_a, -1)
        # landed arrival indices, compacted ascending (A_max-1 padding),
        # with their positions and duration-stream entries
        rank = torch.cumsum(landed.to(torch.int32), 1) - 1
        landed_list = _scatter_drop(
            torch.full((G, A_max), A_max - 1, dtype=torch.int64, device=dev),
            torch.where(landed, rank, A_max).to(torch.int64),
            a_iota.expand(G, A_max).contiguous())
        pos_list = torch.gather(new_pos, 1, landed_list)
        dur_list = torch.gather(durs_s[:, LK:], 1, landed_list)

        # 3+4. BF-S then BF-J as one bounded placement work list.
        dc = torch.zeros(G, dtype=torch.int64, device=dev)
        a_ptr = torch.zeros(G, dtype=torch.int64, device=dev)
        for _ in range(W):
            resid = 1.0 - rsum
            occupied = queue > 0.0
            qmin = torch.where(occupied, queue, inf).amin(1)
            fits = freed & (resid >= qmin[:, None])
            cur = torch.where(fits, l_iota, L).amin(1)
            any_bfs = cur < L
            is_bfj = (~any_bfs) & (a_ptr < n_landed)
            if not bool((any_bfs | is_bfj).any()):
                break  # every remaining step is a no-op for every member

            # BF-S candidate: largest fitting job for server `cur`
            cur = torch.clamp_max(cur, L - 1)
            resid_cur = torch.gather(resid, 1, cur[:, None])
            fitq = torch.where(occupied & (queue <= resid_cur), queue, -inf)
            size_bfs = fitq.amax(1)
            j_bfs = torch.clamp_max(
                torch.where(fitq == size_bfs[:, None], q_iota, Qcap).amin(1),
                Qcap - 1)

            # BF-J candidate: next landed arrival (one attempt each, even if
            # BF-S already consumed its job)
            ap = torch.clamp_max(a_ptr, A_max - 1)
            pos = torch.gather(pos_list, 1, ap[:, None])[:, 0]
            size_bfj = torch.gather(queue, 1,
                                    torch.clamp_min(pos, 0)[:, None])[:, 0]
            feas = resid >= size_bfj[:, None]
            if faulted:
                feas = feas & up_t
            masked_r = torch.where(feas, resid, inf)
            best_r = masked_r.amin(1)
            s_bfj = torch.clamp_max(
                torch.where(masked_r == best_r[:, None], l_iota, L).amin(1),
                L - 1)
            ok_bfj = is_bfj & (best_r < inf) & (size_bfj > 0)

            do = any_bfs | ok_bfj
            tgt = torch.where(any_bfs, cur, s_bfj)
            qidx = torch.where(do, torch.where(any_bfs, j_bfs,
                                               torch.clamp_min(pos, 0)), Qcap)
            size = torch.where(any_bfs, size_bfs, size_bfj)
            dur = torch.where(
                any_bfs,
                torch.gather(durs_s, 1, torch.clamp_max(dc, D - 1)[:, None]
                             )[:, 0],
                torch.gather(dur_list, 1, ap[:, None])[:, 0])

            # first empty slot of the target row; slot 0 when the row is
            # full (the engines' argmax-of-all-False quirk)
            row = srv[g_ar, tgt]
            slot = torch.where(row == 0.0, k_iota, K).amin(1)
            slot = torch.where(slot == K, 0, slot)
            wmask = k_iota == torch.where(do, slot, K)[:, None]
            new_row = torch.where(wmask, size[:, None], row)
            srv[g_ar, tgt] = new_row
            dep[g_ar, tgt] = torch.where(wmask, (t + dur)[:, None],
                                         dep[g_ar, tgt])
            qhit = q_iota == qidx[:, None]
            if faulted:
                # the retry count rides with the job: queue -> server slot
                tr = torch.gather(qtry, 1,
                                  torch.clamp_max(qidx, Qcap - 1)[:, None])
                tries[g_ar, tgt] = torch.where(wmask, tr, tries[g_ar, tgt])
                qtry = torch.where(qhit, 0, qtry)
            queue = torch.where(qhit, 0.0, queue)
            rsum = torch.where(l_iota == torch.where(do, tgt, L)[:, None],
                               row_sum_lr(new_row)[:, None], rsum)
            q_cnt = q_cnt - do.to(torch.int32)
            dc = dc + any_bfs
            a_ptr = a_ptr + is_bfj

        # saturation check: a placement the unbounded policy would still
        # make => the bounded list cut this slot short.  (Missed BF-J
        # attempts whose job was consumed, or fits no server, are no-ops.)
        resid = 1.0 - rsum
        qmin = torch.where(queue > 0.0, queue, inf).amin(1)
        pend_bfs = (freed & (resid >= qmin[:, None])).any(1)
        left = (a_iota >= a_ptr[:, None]) & (a_iota < n_landed[:, None])
        sz_left = torch.gather(queue, 1, torch.clamp_min(pos_list, 0))
        cap_max = (torch.where(up_t, resid, -inf) if faulted
                   else resid).amax(1)
        pend_bfj = (left & (sz_left > 0) & (sz_left <= cap_max[:, None])
                    ).any(1)
        trunc = trunc + (pend_bfs | pend_bfj).to(torch.int32)

        qlen_out[:, s] = q_cnt
        ndep_out[:, s] = n_dep
        rsum_out[:, s] = rsum
        t = t + 1

    state = BFJSState(srv, dep, queue, t, q_cnt, dropped, trunc, qtry, tries,
                      preempted, requeued, lost, up_last)
    # occupancy: the row sums added in ascending row order, as the kernel
    res = PolicyResult(qlen_out, row_sum_lr(rsum_out),
                       torch.cumsum(ndep_out, 1, dtype=torch.int32),
                       dropped, trunc, preempted, requeued, lost)
    return res, state


def ensemble_streams(seeds, lam: float, mu: float, sampler: Callable,
                      L: int, K: int, A_max: int, horizon: int, device,
                      num_resources: int = 1, fault_rate: float = 0.0,
                      repair_rate: float = 1.0) -> SchedStreams:
    """One stream set per integer seed, stacked on a leading G axis.  Each
    member draws from its own ``torch.Generator`` on ``device`` seeded with
    its seed, straight into preallocated ensemble planes (sizes ``(G, T,
    A_max)``, or ``(G, T, A_max, R)`` for ``num_resources`` R > 1)."""
    seeds = [int(s) for s in seeds]
    G, D = len(seeds), L * K + A_max
    n = torch.empty((G, horizon), dtype=torch.int32, device=device)
    lanes = (A_max,) if num_resources == 1 else (A_max, num_resources)
    sizes = torch.empty((G, horizon, *lanes), dtype=torch.float32,
                        device=device)
    durs = torch.empty((G, horizon, D), dtype=torch.int32, device=device)
    up = None if fault_rate == 0.0 else torch.empty(
        (G, horizon, L), dtype=torch.bool, device=device)
    for g, seed in enumerate(seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        st = make_streams(gen, lam, mu, sampler, L=L, K=K, A_max=A_max,
                          horizon=horizon, device=device,
                          num_resources=num_resources,
                          fault_rate=fault_rate, repair_rate=repair_rate)
        n[g], sizes[g], durs[g] = st.n, st.sizes, st.durs
        if up is not None:
            up[g] = st.up
    return SchedStreams(n, sizes, durs, up)


def run_bfjs(seed: int, lam: float, mu: float, sampler: Callable,
             L: int = 8, K: int = 16, Qcap: int = 512, A_max: int = 8,
             horizon: int = 10_000, engine: str = "scan",
             work_steps: int | None = None, window: int | None = None,
             fault_rate: float = 0.0, repair_rate: float = 1.0,
             max_requeue: int = DEFAULT_MAX_REQUEUE, strict: bool = False,
             device=None) -> PolicyResult:
    """Simulate BF-J/S on L unit-capacity servers for ``horizon`` slots.

    ``seed`` seeds the stream generator on ``device`` (default: the card);
    ``sampler(generator, n, device) -> (n,)`` float sizes in (0,1].
    ``engine``: "scan" (branch-free, default) | "cuda" (fused kernel).
    ``fault_rate > 0`` injects per-slot server capacity shocks."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    streams = make_streams(gen, lam, mu, sampler, L=L, K=K, A_max=A_max,
                           horizon=horizon, device=device,
                           fault_rate=fault_rate, repair_rate=repair_rate)
    return run_bfjs_trace(streams, L=L, K=K, Qcap=Qcap, A_max=A_max,
                          engine=engine, work_steps=work_steps, window=window,
                          max_requeue=max_requeue, strict=strict)


def _cuda_ok(streams: SchedStreams, L: int, K: int, Qcap: int, A_max: int,
             strict: bool) -> bool:
    from ...kernels.bfjs.ops import bfjs_scratch_bytes
    from ...kernels.common import cuda_precheck
    return cuda_precheck("bfjs", nbytes=bfjs_scratch_bytes(L, K, Qcap, A_max),
                         fault_plane=streams.up is not None, strict=strict)


def run_bfjs_trace(streams: SchedStreams, *, L: int, K: int, Qcap: int,
                   A_max: int, engine: str = "scan",
                   work_steps: int | None = None,
                   window: int | None = None,
                   max_requeue: int = DEFAULT_MAX_REQUEUE,
                   strict: bool = False) -> PolicyResult:
    """Run BF-J/S over explicit streams (one cluster, or an ensemble with a
    leading G axis) on the streams' device.  ``window`` is validated against
    the horizon for ``engine="cuda"``."""
    _check_sequential_durs(streams, L, K, A_max)
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    if engine == "cuda":
        if _cuda_ok(streams, L, K, Qcap, A_max, strict):
            from ...kernels.bfjs.ops import bfjs_simulate
            single = streams.n.ndim == 1
            res = bfjs_simulate(_batched(streams) if single else streams,
                                L=L, K=K, Qcap=Qcap, A_max=A_max,
                                work_steps=work_steps, window=window)
            return _first(res) if single else res
        engine = "scan"
    if engine == "scan":
        return run_bfjs_streams(streams, L=L, K=K, Qcap=Qcap, A_max=A_max,
                                work_steps=work_steps,
                                max_requeue=max_requeue)
    raise ValueError(f"unknown engine {engine!r}; expected one of "
                     f"{', '.join(ENGINES)}")


def monte_carlo_bfjs(seeds, lam: float, mu: float, sampler: Callable,
                     engine: str = "scan", work_steps: int | None = None,
                     window: int | None = None,
                     L: int = 8, K: int = 16, Qcap: int = 512,
                     A_max: int = 8, horizon: int = 10_000,
                     fault_rate: float = 0.0, repair_rate: float = 1.0,
                     max_requeue: int = DEFAULT_MAX_REQUEUE,
                     strict: bool = False, device=None) -> PolicyResult:
    """One simulated cluster per integer seed, batched on a leading G axis.

    Every member's streams are generated on ``device`` (default: the card);
    "scan" runs them batched, "cuda" runs the fused kernel with one thread
    block per member."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    device = resolve_device(device)
    streams = ensemble_streams(seeds, lam, mu, sampler, L=L, K=K,
                                A_max=A_max, horizon=horizon, device=device,
                                fault_rate=fault_rate,
                                repair_rate=repair_rate)
    return run_bfjs_trace(streams, L=L, K=K, Qcap=Qcap, A_max=A_max,
                          engine=engine, work_steps=work_steps, window=window,
                          max_requeue=max_requeue, strict=strict)


def run_bfjs_workload(workload, seed: int = 0, *, engine: str = "scan",
                      **config) -> PolicyResult:
    """Workload-first adapter: the registry entry behind
    ``run_policy(workload, policy="bfjs", ...)``.  BF-J/S is
    single-resource with unit servers; vector workloads are rejected."""
    workload.require_scalar("bfjs")
    workload.check_sampler()
    return run_bfjs(seed, workload.lam, workload.mu, workload.sampler,
                    engine=engine, **config)


def monte_carlo_bfjs_workload(workload, seeds, *, engine: str = "scan",
                              **config) -> PolicyResult:
    """Workload-first adapter for ``monte_carlo_policy(policy="bfjs")``."""
    workload.require_scalar("bfjs")
    workload.check_sampler()
    return monte_carlo_bfjs(seeds, workload.lam, workload.mu,
                            workload.sampler, engine=engine, **config)
