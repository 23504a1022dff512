"""Multi-resource BF-J/S engines (paper Section VIII), torch port of
``repro.core.engine.bfjs_mr`` (``policy="bfjs-mr"``).

Three engines share one trajectory semantics:

  * ``engine="reference"`` — the event-driven ``MultiResourceBFJS`` numpy
    oracle (``core/multi_resource.py``) driven slot by slot from the same
    ``SchedStreams`` on the host: the behavioural anchor;
  * ``engine="scan"`` — the branch-free slot engine: per slot, a bounded
    work list of masked-select steps over ``(L, R)`` integer occupancy
    planes and ``(Qcap, R)`` queued demand vectors.  It runs batched over a
    leading ensemble axis G (the JAX package's ``vmap``) with a Python loop
    over slots (its ``lax.scan``), and is the plain version of the CUDA
    kernel (``kernels/bfjs_mr/ref.py``);
  * ``engine="cuda"`` — the fused slot-step kernel in ``kernels/bfjs_mr``:
    one thread block per ensemble member.

Semantics of one slot (the oracle's ``step``):

  1. departures free their demand vectors;
  2. arrivals join the queue (first-empty positions, arrival-order seq ids);
  3. BF-S over freed servers in ascending order: repeatedly place the
     queued job with the LARGEST total demand that fits (ties: lowest seq);
  4. BF-J over the slot's arrivals in order: place each still-queued job on
     the feasible server with the LOWEST alignment score
     ``<demand, available>`` (ties: lowest server index).

Demands and occupancies are ``quantize.RES`` grid integers and the score is
the exact int32 ``(hi, lo)`` pair of ``ops.alignment_score_pair``, so
"scan" and "cuda" equal the JAX ``run_bfjs_mr_streams`` on every field,
occupancy included, and equal "reference" whenever ``truncated == 0``.

Fixed-shape deviations (counted, never silent): queue overflow beyond
``Qcap`` drops arrivals (``dropped``); a placement onto a server whose
``K`` job slots are full is skipped and counted (``truncated``), as are
slots that exhaust the ``work_steps`` bound with placements still pending.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve_device
from ..quantize import RES
from .bfjs import DEFAULT_MAX_REQUEUE, _batched, _first, ensemble_streams
from .ops import alignment_score_pair, first_empty_positions, to_grid_t
from .streams import (INF_SLOT, PolicyResult, SchedStreams,
                      resolve_work_steps)

INT32_MAX = 2 ** 31 - 1

ENGINES = ("scan", "cuda", "reference")


class BFJSMRState(NamedTuple):
    """The complete carry of the scan engine, in the order of the JAX
    package's scan carry (``run_bfjs_mr_streams(..., return_state=True)``).
    Batched runs carry a leading G axis on every field."""
    dem: torch.Tensor        # (L, K, R) i32 demand vectors in service
    dep: torch.Tensor        # (L, K) i32 departure slot (INF_SLOT if empty)
    occ: torch.Tensor        # (L, R) i32 occupied capacity per resource
    qdem: torch.Tensor       # (Qcap, R) i32 queued demand vectors
    qdur: torch.Tensor       # (Qcap,) i32 queued durations
    qseq: torch.Tensor       # (Qcap,) i32 queue seq ids (-1 = empty)
    t: torch.Tensor          # () i32 next slot index
    q_cnt: torch.Tensor      # () i32 queued jobs
    seq0: torch.Tensor       # () i32 next seq id
    dropped: torch.Tensor    # () i32
    truncated: torch.Tensor  # () i32
    qtry: torch.Tensor       # (Qcap,) i32 retry counts of queued jobs
    tries: torch.Tensor      # (L, K) i32 retry counts of resident jobs
    sseq: torch.Tensor       # (L, K) i32 seq ids of resident jobs
    preempted: torch.Tensor  # () i32
    requeued: torch.Tensor   # () i32
    lost: torch.Tensor       # () i32
    up_last: torch.Tensor    # (L,) bool previous slot's fault-plane row


def initial_state(G: int, L: int, K: int, Qcap: int, R: int,
                  device) -> BFJSMRState:
    """Empty cluster, empty queue, slot 0, for G ensemble members."""

    def full(shape, v, dtype=torch.int32):
        return torch.full((G, *shape), v, dtype=dtype, device=device)

    z = full((), 0)
    return BFJSMRState(
        dem=full((L, K, R), 0), dep=full((L, K), INF_SLOT),
        occ=full((L, R), 0), qdem=full((Qcap, R), 0), qdur=full((Qcap,), 1),
        qseq=full((Qcap,), -1), t=z, q_cnt=z, seq0=z, dropped=z,
        truncated=z, qtry=full((Qcap,), 0), tries=full((L, K), 0),
        sseq=full((L, K), 0), preempted=z, requeued=z, lost=z,
        up_last=full((L,), True, torch.bool))


def _norm_capacity(capacity, R: int) -> tuple[float, ...]:
    """Per-resource server capacity as a length-R tuple of floats > 0."""
    if not isinstance(capacity, tuple):
        capacity = (float(capacity),) * R
    if len(capacity) != R:
        raise ValueError(
            f"capacity has {len(capacity)} entries for R={R} resources")
    if any(c <= 0 for c in capacity):
        raise ValueError(f"capacity entries must be > 0, got {capacity}")
    return tuple(float(c) for c in capacity)


def _lift_sizes(streams: SchedStreams) -> SchedStreams:
    """bfjs-mr consumes (T, A_max, R) sizes; lift squeezed R=1 streams."""
    if streams.sizes.ndim == streams.durs.ndim:
        return streams._replace(sizes=streams.sizes[..., None])
    return streams


def _scatter(x: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` along axis 1 of a ``(G, Q, ...)``
    plane: an index equal to ``Q`` means "no write".  ``idx`` is ``(G, N)``
    and ``vals`` ``(G, N, ...)``."""
    G, Q = x.shape[:2]
    pad = torch.cat([x, x.new_zeros(G, 1, *x.shape[2:])], dim=1)
    index = idx.to(torch.int64).reshape(G, -1, *([1] * (x.ndim - 2)))
    pad.scatter_(1, index.expand(-1, -1, *x.shape[2:]),
                 vals.to(x.dtype).expand(G, idx.shape[1], *x.shape[2:]))
    return pad[:, :Q]


def _preempt_planes(dem, dep, occ, qdem, qdur, qseq, qtry, tries, sseq,
                    seq0, q_cnt, up_t, t, max_requeue):
    """Evict every job in service on a down server (batched over G).

    Victims with ``tries < max_requeue`` re-enter the queue at the first
    empty positions in ascending current-``seq`` order, carrying their
    REMAINING duration, ``tries + 1`` and a FRESH seq id — the oracle's
    dict-insertion order (requeues before the slot's arrivals), so BF-S
    tie-breaks keep matching.  Exhausted victims (and any that find the
    queue full) are dropped entirely and counted ``lost``.  Returns the
    updated planes plus ``(n_preempted, n_requeued, n_lost)`` (G,)."""
    G, L, K, R = dem.shape
    Qcap = qseq.shape[1]
    victim = (~up_t)[..., None] & (dep != INF_SLOT)
    vic_f = victim.reshape(G, -1)
    elig = vic_f & (tries.reshape(G, -1) < max_requeue)
    # rank eligible victims by current seq; ineligible sort to the back
    key = torch.where(elig, sseq.reshape(G, -1), INT32_MAX)
    rank_of = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1,
                            stable=True).to(torch.int32)
    n_empty = torch.cumsum((qseq < 0).to(torch.int32), 1).contiguous()
    pos = torch.searchsorted(n_empty, (rank_of + 1).contiguous())
    land = elig & (pos < Qcap)
    at = torch.where(land, pos, Qcap)
    rem = torch.clamp_min(dep.reshape(G, -1) - t[:, None], 1)
    qdem = _scatter(qdem, at, dem.reshape(G, -1, R))
    qdur = _scatter(qdur, at, rem)
    qtry = _scatter(qtry, at, tries.reshape(G, -1) + 1)
    qseq = _scatter(qseq, at, seq0[:, None] + rank_of)
    n_vict = vic_f.sum(1, dtype=torch.int32)
    n_req = land.sum(1, dtype=torch.int32)
    seq0 = seq0 + n_req
    q_cnt = q_cnt + n_req
    occ = occ - (dem * victim[..., None]).sum(2, dtype=torch.int32)
    dem = torch.where(victim[..., None], 0, dem)
    dep = torch.where(victim, INF_SLOT, dep)
    tries = torch.where(victim, 0, tries)
    sseq = torch.where(victim, 0, sseq)
    return (dem, dep, occ, qdem, qdur, qseq, qtry, tries, sseq, seq0,
            q_cnt, n_vict, n_req, n_vict - n_req)


def run_bfjs_mr_streams(streams: SchedStreams, L: int, K: int, Qcap: int,
                        A_max: int, work_steps: int | None = None,
                        capacity: tuple[float, ...] | float = 1.0,
                        max_requeue: int = DEFAULT_MAX_REQUEUE,
                        state: BFJSMRState | None = None,
                        return_state: bool = False):
    """Branch-free multi-resource BF-J/S slot engine over streams.

    ``streams`` fields are ``(T, ...)`` for one cluster or ``(G, T, ...)``
    for an ensemble; sizes are ``(..., A_max, R)`` demand vectors (squeezed
    R=1 streams are lifted).  Inside each slot the BF-S refill and BF-J
    placement passes are one bounded work list of at most ``work_steps``
    steps.  Each step either performs the BF-S placement for the
    lowest-index freed, unblocked server that still has a fitting queued
    job, or attempts the next landed arrival's BF-J placement.  Placements
    only consume queue entries and only shrink availability, so this order
    reproduces the oracle's nested loops exactly.  The list stops early
    once no member has a step left: the remaining steps would change
    nothing.

    Streams carrying a fault plane run the fault-injected variant
    (``_preempt_planes`` eviction, down servers out of the BF-J feasible
    set, recoveries rejoin the BF-S freed set).  ``state=`` /
    ``return_state=True`` thread the complete carry (:class:`BFJSMRState`):
    running the horizon in slices reproduces the straight-through
    trajectory bit for bit; per-slice ``departed`` restarts from 0.
    """
    streams = _lift_sizes(streams)
    single = streams.n.ndim == 1
    if single:
        streams = _batched(streams)
        if state is not None:
            state = BFJSMRState(*(x[None] for x in state))
    G, R = streams.n.shape[0], streams.sizes.shape[-1]
    cap = _norm_capacity(capacity, R)
    if state is None:
        state = initial_state(G, L, K, Qcap, R, streams.n.device)
    res, state = _scan(streams, L, K, Qcap, A_max,
                       resolve_work_steps(work_steps, A_max), cap,
                       max_requeue, state)
    if single:
        res, state = _first(res), _first(state)
    return (res, state) if return_state else res


def _fits(occ, qdem, qseq, servers, CAP):
    """(G, L, Qcap): queued job j fits on server i, for ``servers`` (G, L)."""
    avail = CAP - occ                                         # (G, L, R)
    fit = (qdem[:, None, :, :] <= avail[:, :, None, :]).all(-1)
    return fit & servers[..., None] & (qseq >= 0)[:, None, :]


def _scan(streams: SchedStreams, L: int, K: int, Qcap: int, A_max: int,
          W: int, cap: tuple[float, ...], max_requeue: int,
          state: BFJSMRState):
    n, sizes, durs, up = streams
    G, T = n.shape
    R = sizes.shape[-1]
    dev = n.device
    faulted = up is not None
    CAP = torch.tensor([round(c * RES) for c in cap], dtype=torch.int32,
                       device=dev)
    a_iota = torch.arange(A_max, device=dev)
    l_iota = torch.arange(L, device=dev)
    q_iota = torch.arange(Qcap, device=dev)
    k_iota = torch.arange(K, device=dev)
    g_ar = torch.arange(G, device=dev)
    dur_off = durs.shape[-1] - A_max

    (dem, dep, occ, qdem, qdur, qseq, t, q_cnt, seq0, dropped, trunc, qtry,
     tries, sseq, preempted, requeued, lost, up_last) = (
        x.clone() for x in state)
    qlen_out = torch.empty((G, T), dtype=torch.int32, device=dev)
    occ_out = torch.empty((G, T, R), dtype=torch.int32, device=dev)
    ndep_out = torch.empty((G, T), dtype=torch.int32, device=dev)

    for s in range(T):
        up_t = up[:, s] if faulted else None

        # 1. departures
        leaving = dep == t[:, None, None]
        freed = leaving.any(-1)
        n_dep = leaving.sum((1, 2), dtype=torch.int32)
        occ = occ - (dem * leaving[..., None]).sum(2, dtype=torch.int32)
        dem = torch.where(leaving[..., None], 0, dem)
        dep = torch.where(leaving, INF_SLOT, dep)
        tries = torch.where(leaving, 0, tries)
        sseq = torch.where(leaving, 0, sseq)

        # 1b. fault preemption: down servers evict, victims requeue or are
        # lost; recovered servers rejoin the BF-S freed set.
        if faulted:
            (dem, dep, occ, qdem, qdur, qseq, qtry, tries, sseq, seq0,
             q_cnt, n_v, n_r, n_l) = _preempt_planes(
                dem, dep, occ, qdem, qdur, qseq, qtry, tries, sseq, seq0,
                q_cnt, up_t, t, max_requeue)
            preempted = preempted + n_v
            requeued = requeued + n_r
            lost = lost + n_l
            freed = (freed | (up_t & ~up_last)) & up_t
            up_last = up_t

        # 2. arrivals -> first empty queue positions (grid-quantized)
        n_s = n[:, s]
        g = to_grid_t(sizes[:, s])                           # (G, A, R)
        pos_a, landed = first_empty_positions(qseq < 0,
                                              a_iota < n_s[:, None])
        n_landed = landed.sum(1, dtype=torch.int32)
        dropped = dropped + n_s - n_landed
        q_cnt = q_cnt + n_landed
        wpos = torch.where(landed, pos_a, Qcap)
        qdem = _scatter(qdem, wpos, torch.where(landed[..., None], g, 0))
        qdur = _scatter(qdur, wpos, durs[:, s, dur_off:])
        qseq = _scatter(qseq, wpos, seq0[:, None] + a_iota)
        qtry = _scatter(qtry, wpos, torch.zeros_like(wpos))
        seq0 = seq0 + n_s
        # landed arrivals are a prefix of the slot's lanes, so the compacted
        # landed list is the lanes themselves
        pos_list = torch.where(landed, pos_a, -1)

        # 3+4. BF-S then BF-J as one bounded early-exit work list
        blocked = torch.zeros(G, dtype=torch.bool, device=dev)
        a_ptr = torch.zeros(G, dtype=torch.int64, device=dev)
        for _ in range(W):
            avail = CAP - occ
            # BF-S candidate: lowest-index freed, unblocked server with a
            # fitting job; its job = largest total demand, earliest seq.
            fits = _fits(occ, qdem, qseq, freed & ~blocked[:, None], CAP)
            cur = torch.where(fits.any(-1), l_iota, L).amin(1)
            any_bfs = cur < L
            is_bfj = (~any_bfs) & (a_ptr < n_landed)
            if not bool((any_bfs | is_bfj).any()):
                break  # every remaining step is a no-op for every member
            cur_c = torch.clamp_max(cur, L - 1)
            fit_cur = fits[g_ar, cur_c]                      # (G, Qcap)
            tot = qdem.sum(-1, dtype=torch.int32)
            best_tot = torch.where(fit_cur, tot, -1).amax(1)
            cand = fit_cur & (tot == best_tot[:, None])
            best_seq = torch.where(cand, qseq, INT32_MAX).amin(1)
            j_bfs = torch.clamp_max(torch.where(
                cand & (qseq == best_seq[:, None]), q_iota, Qcap).amin(1),
                Qcap - 1)

            # BF-J candidate: next landed arrival still in the queue, on the
            # min-alignment feasible server (any server, not only freed).
            ap = torch.clamp_max(a_ptr, A_max - 1)
            pos = pos_list[g_ar, ap]
            posc = torch.clamp_min(pos, 0)
            present = is_bfj & (pos >= 0) & (qseq[g_ar, posc] >= 0)
            d_bfj = qdem[g_ar, posc]                         # (G, R)
            feas = (d_bfj[:, None, :] <= avail).all(-1)
            if faulted:
                feas = feas & up_t
            s_hi, s_lo = alignment_score_pair(avail, d_bfj)
            best_hi = torch.where(feas, s_hi, INT32_MAX).amin(1)
            cand_j = feas & (s_hi == best_hi[:, None])
            best_lo = torch.where(cand_j, s_lo, INT32_MAX).amin(1)
            s_bfj = torch.clamp_max(torch.where(
                cand_j & (s_lo == best_lo[:, None]), l_iota, L).amin(1),
                L - 1)
            ok_bfj = present & feas.any(1)

            do = any_bfs | ok_bfj
            tgt = torch.where(any_bfs, cur_c, s_bfj)
            qidx = torch.where(any_bfs, j_bfs, posc)
            d_place = qdem[g_ar, qidx]
            dur = qdur[g_ar, qidx]
            try_pl = qtry[g_ar, qidx]
            seq_pl = qseq[g_ar, qidx]

            row_dep = dep[g_ar, tgt]
            slot = torch.where(row_dep == INF_SLOT, k_iota, K).amin(1)
            ok_slot = slot < K
            place = do & ok_slot
            wm = (k_iota == torch.where(place, slot, K)[:, None])  # (G, K)
            dem[g_ar, tgt] = torch.where(wm[..., None], d_place[:, None, :],
                                         dem[g_ar, tgt])
            dep[g_ar, tgt] = torch.where(wm, (t + dur)[:, None],
                                         dep[g_ar, tgt])
            tries[g_ar, tgt] = torch.where(wm, try_pl[:, None],
                                           tries[g_ar, tgt])
            sseq[g_ar, tgt] = torch.where(wm, seq_pl[:, None],
                                          sseq[g_ar, tgt])
            occ[g_ar, tgt] += torch.where(place[:, None], d_place, 0)
            qclr = q_iota == torch.where(place, qidx, Qcap)[:, None]
            qseq = torch.where(qclr, -1, qseq)
            qdem = torch.where(qclr[..., None], 0, qdem)
            qtry = torch.where(qclr, 0, qtry)
            q_cnt = q_cnt - place.to(torch.int32)
            # K-full server: the oracle would place; count, don't spin.  As
            # in the JAX engine, one K-full BF-S target ends the BF-S pass
            # for the slot (the flag covers every server).
            trunc = trunc + (do & ~ok_slot).to(torch.int32)
            blocked = blocked | (any_bfs & ~ok_slot)
            a_ptr = a_ptr + is_bfj

        # saturation check: work the oracle would still do => the bounded
        # list diverged this slot (K-full blocks were already counted).
        avail = CAP - occ
        pend_bfs = _fits(occ, qdem, qseq, freed & ~blocked[:, None],
                         CAP).flatten(1).any(1)
        left = (a_iota >= a_ptr[:, None]) & (a_iota < n_landed[:, None])
        posb = torch.clamp_min(pos_list, 0)
        present_l = left & (pos_list >= 0) & (torch.gather(qseq, 1, posb)
                                                >= 0)
        d_l = qdem[g_ar[:, None], posb]                      # (G, A, R)
        feas_l = (d_l[:, :, None, :] <= avail[:, None, :, :]).all(-1)
        if faulted:
            feas_l = feas_l & up_t[:, None, :]
        pend_bfj = (present_l & feas_l.any(-1)).any(1)
        trunc = trunc + (pend_bfs | pend_bfj).to(torch.int32)

        qlen_out[:, s] = q_cnt
        occ_out[:, s] = occ.sum(1, dtype=torch.int32)
        ndep_out[:, s] = n_dep
        t = t + 1

    state = BFJSMRState(dem, dep, occ, qdem, qdur, qseq, t, q_cnt, seq0,
                        dropped, trunc, qtry, tries, sseq, preempted,
                        requeued, lost, up_last)
    # occupancy: the int32 grid sum per resource in float32, over RES
    res = PolicyResult(qlen_out, occ_out.to(torch.float32) / RES,
                       torch.cumsum(ndep_out, 1, dtype=torch.int32),
                       dropped, trunc, preempted, requeued, lost)
    return res, state


def _run_bfjs_mr_reference(streams: SchedStreams, *, L: int,
                           capacity: tuple[float, ...] | float = 1.0,
                           max_requeue: int = DEFAULT_MAX_REQUEUE
                           ) -> PolicyResult:
    """The event-driven ``MultiResourceBFJS`` oracle driven from streams.

    Host-side numpy, slot by slot, one member after another for batched
    streams; the result lands on the streams' device.  Demands are the
    engines' grid quantization (``max(rint(s * RES), 1)``) replayed as the
    exact dyadics ``g / RES``, and the capacity is quantized to the grid
    too, so every feasibility comparison is exact and agrees with the
    integer engines.  With a fault plane the oracle is stepped with
    ``down = ~up[t]`` and the counters come from its fault accounting (lost
    jobs never depart, so cumulative departures subtract them).  The oracle
    has no fixed-size buffers: ``dropped`` and ``truncated`` are always 0.
    """
    from ..multi_resource import MRJob, MultiResourceBFJS

    streams = _lift_sizes(streams)
    if streams.n.ndim == 2:
        members = [_run_bfjs_mr_reference(
            SchedStreams(*(None if x is None else x[g] for x in streams)),
            L=L, capacity=capacity, max_requeue=max_requeue)
            for g in range(streams.n.shape[0])]
        return PolicyResult(*(None if xs[0] is None else torch.stack(xs)
                              for xs in zip(*members)))
    dev = streams.n.device
    n = streams.n.cpu().numpy()
    sizes = streams.sizes.cpu().numpy().astype(np.float64)
    durs = streams.durs.cpu().numpy()
    up = None if streams.up is None else streams.up.cpu().numpy()
    T, A_max, R = sizes.shape
    capacity = _norm_capacity(capacity, R)
    cap_dyadic = tuple(round(c * RES) / RES for c in capacity)
    dem = np.maximum(np.rint(sizes * RES), 1.0) / RES
    dur_off = durs.shape[-1] - A_max

    policy = MultiResourceBFJS(L, R, capacity=cap_dyadic)
    qlen = np.zeros(T, dtype=np.int32)
    occ = np.zeros((T, R), dtype=np.float64)
    dep_cum = np.zeros(T, dtype=np.int32)
    jid = 0
    for t in range(T):
        jobs = []
        for a in range(int(n[t])):
            jobs.append(MRJob(jid, dem[t, a], t, int(durs[t, dur_off + a])))
            jid += 1
        down = None if up is None else ~up[t]
        policy.step(t, jobs, down=down, max_requeue=max_requeue)
        q = policy.queue_len()
        qlen[t] = q
        occ[t] = policy.occupied.sum(axis=0)
        in_service = sum(len(s) for s in policy.jobs)
        dep_cum[t] = jid - in_service - q - policy.lost

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return PolicyResult(
        torch.from_numpy(qlen).to(dev),
        torch.from_numpy(occ.astype(np.float32)).to(dev),
        torch.from_numpy(dep_cum).to(dev), i32(0), i32(0),
        i32(policy.preempted), i32(policy.requeued), i32(policy.lost))


def _cuda_ok(streams: SchedStreams, L: int, K: int, Qcap: int, A_max: int,
             strict: bool) -> bool:
    """The kernel gate: a fault plane, or a block over the shared-memory
    limit, gives way to the scan engine.  The block's size is read from
    the built kernel, so only for card tensors: on the CPU the wrapper runs
    the plain version."""
    from ...kernels.bfjs_mr.ops import bfjs_mr_shared_bytes
    from ...kernels.common import cuda_precheck
    fault = streams.up is not None
    on_card = not fault and streams.n.device.type == "cuda"
    R = int(streams.sizes.shape[-1])
    return cuda_precheck(
        "bfjs_mr", nbytes=bfjs_mr_shared_bytes(L, K, Qcap, A_max, R)
        if on_card else 0, fault_plane=fault, strict=strict)


def run_bfjs_mr_trace(streams: SchedStreams, *, L: int, K: int = 16,
                      Qcap: int = 512, A_max: int | None = None,
                      engine: str = "scan", work_steps: int | None = None,
                      capacity: tuple[float, ...] | float = 1.0,
                      window: int | None = None,
                      max_requeue: int = DEFAULT_MAX_REQUEUE,
                      strict: bool = False) -> PolicyResult:
    """Run one multi-resource BF-J/S simulation (or an ensemble with a
    leading G axis) over explicit streams, on the streams' device.

    Accepts trace-built streams (per-arrival duration lanes only, the
    ``streams_from_trace(trace, collapse=False)`` path) and ``make_streams``
    full-width streams (the engines read the last ``A_max`` lanes;
    durations attach at arrival).  ``window`` is validated against the
    horizon for ``engine="cuda"``.  ``engine="cuda"`` is gated by
    ``kernels.common.cuda_precheck``: a fault plane or a shared-memory
    overflow moves loudly to the bit-identical scan engine (or raises,
    ``strict=True``)."""
    streams = _lift_sizes(streams)
    if A_max is None:
        A_max = int(streams.sizes.shape[-2])
    R = int(streams.sizes.shape[-1])
    capacity = _norm_capacity(capacity, R)
    if engine == "reference":
        return _run_bfjs_mr_reference(streams, L=L, capacity=capacity,
                                      max_requeue=max_requeue)
    if engine == "cuda":
        if _cuda_ok(streams, L, K, Qcap, A_max, strict):
            from ...kernels.bfjs_mr.ops import bfjs_mr_simulate
            single = streams.n.ndim == 1
            res = bfjs_mr_simulate(_batched(streams) if single else streams,
                                   L=L, K=K, Qcap=Qcap, A_max=A_max,
                                   work_steps=work_steps, capacity=capacity,
                                   window=window)
            return _first(res) if single else res
        engine = "scan"
    if engine == "scan":
        return run_bfjs_mr_streams(streams, L=L, K=K, Qcap=Qcap,
                                   A_max=A_max, work_steps=work_steps,
                                   capacity=capacity,
                                   max_requeue=max_requeue)
    raise ValueError(f"unknown engine {engine!r}; expected one of "
                     f"{', '.join(ENGINES)}")


def run_bfjs_mr_workload(workload, seed: int = 0, *, engine: str = "scan",
                         **config) -> PolicyResult:
    """Simulate multi-resource BF-J/S for one ``Workload``: the registry
    entry behind ``run_policy(workload, seed, policy="bfjs-mr", ...)``, the
    one-member ensemble of :func:`monte_carlo_bfjs_mr_workload`."""
    return _first(monte_carlo_bfjs_mr_workload(workload, [seed],
                                               engine=engine, **config))


def monte_carlo_bfjs_mr_workload(workload, seeds, *, engine: str = "scan",
                                 L: int = 8, K: int = 16, Qcap: int = 512,
                                 A_max: int = 8, horizon: int = 10_000,
                                 work_steps: int | None = None,
                                 window: int | None = None,
                                 fault_rate: float = 0.0,
                                 repair_rate: float = 1.0,
                                 max_requeue: int = DEFAULT_MAX_REQUEUE,
                                 strict: bool = False,
                                 device=None) -> PolicyResult:
    """One simulated cluster per integer seed, batched on a leading G axis:
    every member's streams are generated on ``device`` (default: the card);
    "scan" runs them batched, "cuda" runs the fused kernel with one thread
    block per member, "reference" steps the host oracle member by member."""
    workload.check_sampler()
    device = resolve_device(device)
    streams = ensemble_streams(seeds, workload.lam, workload.mu,
                               workload.sampler, L=L, K=K, A_max=A_max,
                               horizon=horizon, device=device,
                               num_resources=workload.num_resources,
                               fault_rate=fault_rate,
                               repair_rate=repair_rate)
    return run_bfjs_mr_trace(streams, L=L, K=K, Qcap=Qcap, A_max=A_max,
                             engine=engine, work_steps=work_steps,
                             capacity=workload.capacity, window=window,
                             max_requeue=max_requeue, strict=strict)
