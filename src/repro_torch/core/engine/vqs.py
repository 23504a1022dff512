"""VQS cluster engines (paper Section V, Theorem 3: >= 2/3 rho*), torch
port of ``repro.core.engine.vqs``.

Two engines share one trajectory semantics:

  * ``engine="scan"`` — the branch-free slot engine: per slot, a bounded
    work list of masked-select steps.  Each step (a) advances past EVERY
    pending visited server that cannot place (their renewals collapse to
    one shared max-weight configuration because the VQ-size vector is
    unchanged between placements, and their subscriptions are pure mask
    writes), then (b) fully serves the first server that can place — the
    head-of-VQ packing loop is a prefix-fit over a ``drain``-wide window of
    consecutive ring entries.  It runs batched over a leading ensemble axis
    G (the JAX package's ``vmap``) with a Python loop over slots (its
    ``lax.scan``), and is the plain version of the CUDA kernel
    (``kernels/vqs/ref.py``);
  * ``engine="cuda"`` — the fused slot-step kernel in ``kernels/vqs``: one
    thread block per ensemble member.

All capacity arithmetic is exact integer math on the ``quantize.RES``
grid, so both equal the JAX ``run_vqs_streams`` on every field of shared
streams, occupancy included.  The JAX ``"reference"`` oracle has no
counterpart here yet.

Fixed-shape deviations (counted, never silent):

  * each virtual queue is a ``Qcap``-entry ring; arrivals that overflow
    their ring are dropped and counted (``dropped``);
  * each server holds at most ``K`` jobs; a placement the paper's unbounded
    model would make onto a full server is counted in ``truncated``
    (choose ``K >= 2**J`` to make this impossible);
  * a slot that needs more than ``work_steps`` placing servers is finished
    lazily (remaining placements postponed to later wake-ups) and counted
    in ``truncated``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...device import resolve_device
from ..quantize import RES, TWO_THIRDS
from .bfjs import DEFAULT_MAX_REQUEUE, _batched, _first, ensemble_streams
from .ops import k_red_t, max_weight_config, to_grid_t, vq_type_of_grid
from .streams import (INF_SLOT, PolicyResult, SchedStreams, make_streams,
                      resolve_work_steps)

CAP = RES             # unit server capacity on the grid
RESERVE = TWO_THIRDS  # (2*CAP + 1) // 3, the paper's VQ_1 reservation

ENGINES = ("scan", "cuda")

_REFERENCE_TODO = (
    "the VQS and VQS-BF \"reference\" engines (nested-loop oracles over "
    "streams) are not ported yet (ROADMAP queue 1 item 4a); use "
    "engine=\"scan\" or engine=\"cuda\"")


class VQSState(NamedTuple):
    """The complete carry of the VQS scan engine, in the order of the JAX
    package's scan carry (``run_vqs_streams(..., return_state=True)``).
    Batched runs carry a leading G axis on every field."""
    srv: torch.Tensor        # (L, K) i32 effective sizes (0 = empty)
    dep: torch.Tensor        # (L, K) i32 departure slot (INF_SLOT if empty)
    vqof: torch.Tensor       # (L, K) i32 VQ type of the job (-1 if empty)
    ring_eff: torch.Tensor   # (2J, Qcap) i32 queued effective sizes
    ring_dur: torch.Tensor   # (2J, Qcap) i32 queued durations
    head: torch.Tensor       # (2J,) i32 ring heads (monotone)
    qcnt: torch.Tensor       # (2J,) i32 queued jobs per VQ
    cfg_k1: torch.Tensor     # (L,) bool active configuration has k_1 > 0
    cfg_js: torch.Tensor     # (L,) i32 its j* (-1 if none)
    has_cfg: torch.Tensor    # (L,) bool server has a configuration
    in_empty: torch.Tensor   # (L,) bool the scheduler's _empty membership
    want: torch.Tensor       # (L, 2J) bool subscriptions
    t: torch.Tensor          # () i32 next slot index
    dropped: torch.Tensor    # () i32
    truncated: torch.Tensor  # () i32
    ring_try: torch.Tensor   # (2J, Qcap) i32 retry counts of queued jobs
    srv_try: torch.Tensor    # (L, K) i32 retry counts of resident jobs
    preempted: torch.Tensor  # () i32
    requeued: torch.Tensor   # () i32
    lost: torch.Tensor       # () i32
    up_last: torch.Tensor    # (L,) bool previous slot's fault-plane row


def _default_drain(K: int, J: int) -> int:
    # widest useful packing burst: a server cannot hold more than K jobs,
    # nor more than 2**J of the smallest effective size CAP >> J.
    return max(1, min(K, 1 << J, 16))


def _decode_config(row: torch.Tensor, J: int):
    """(k1, jstar) of K_RED rows ``(..., 2J)`` — jstar is the first nonzero
    type != 1 (-1 if none), replicating ``VQS._set_config``."""
    nvq = 2 * J
    j_iota = torch.arange(nvq, device=row.device)
    k1 = row[..., 1] > 0
    js = torch.where((row > 0) & (j_iota != 1), j_iota, nvq).amin(-1)
    return k1, torch.where(js == nvq, -1, js).to(torch.int32)


def _mw_config(confs: torch.Tensor, qcnt: torch.Tensor, J: int):
    """First-index max-weight row over K_RED (paper Eq. 8, np.argmax
    ties), decoded."""
    return _decode_config(max_weight_config(confs, qcnt)[1], J)


def _scatter_rows(plane: torch.Tensor, vq: torch.Tensor, pos: torch.Tensor,
                  land: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``plane.at[vq, pos].set(vals, mode="drop")`` on a batched ``(G, 2J,
    Qcap)`` plane, where lanes that did not land write nothing."""
    G, nvq, Qcap = plane.shape
    flat = torch.cat([plane.reshape(G, nvq * Qcap),
                      plane.new_zeros(G, 1)], dim=1)
    idx = torch.where(land, vq.to(torch.int64) * Qcap + pos, nvq * Qcap)
    flat.scatter_(1, idx, vals.to(plane.dtype))
    return flat[:, :nvq * Qcap].reshape(G, nvq, Qcap)


def _push_arrivals(ring_eff, ring_dur, head, qcnt, dropped, n_t, sizes_t,
                   durs_t, *, J, Qcap, A_max, ring_try=None):
    """Classify + enqueue one slot's arrivals (batched over G, order-exact).

    Durations come from the LAST ``A_max`` lanes of the duration stream —
    the per-arrival lanes shared by ``make_streams`` (full width) and
    ``streams_from_trace`` (lanes only), so a job's duration always travels
    with the job.  Returns updated rings/counts plus the ``arrived`` type
    mask ``(G, 2J)`` that drives subscription wake-ups (all sampled
    arrivals wake, as in the numpy engine — a dropped arrival already flags
    the run via ``dropped``).  On fault-injected runs fresh arrivals zero
    their ``ring_try`` entry."""
    nvq = 2 * J
    dev = n_t.device
    a_iota = torch.arange(A_max, device=dev)
    j_iota = torch.arange(nvq, device=dev)
    g = to_grid_t(sizes_t)
    vq = vq_type_of_grid(g, J)
    eff = torch.where(vq == nvq - 1, torch.clamp_min(g, RES >> J), g)
    valid = a_iota < n_t[:, None]                                # (G, A)
    oh = (vq[..., None] == j_iota) & valid[..., None]            # (G, A, 2J)
    ohi = oh.to(torch.int32)
    rank = ((torch.cumsum(ohi, 1) - 1) * ohi).sum(-1)
    cnt_own = (ohi * qcnt[:, None, :]).sum(-1)
    head_own = (ohi * head[:, None, :]).sum(-1)
    land = valid & (cnt_own + rank < Qcap)
    pos = (head_own + cnt_own + rank) % Qcap
    ring_eff = _scatter_rows(ring_eff, vq, pos, land, eff)
    ring_dur = _scatter_rows(ring_dur, vq, pos, land,
                             durs_t[:, durs_t.shape[1] - A_max:])
    if ring_try is not None:
        ring_try = _scatter_rows(ring_try, vq, pos, land,
                                 torch.zeros_like(eff))
    qcnt = qcnt + (oh & land[..., None]).sum(1, dtype=torch.int32)
    dropped = dropped + (valid & ~land).sum(1, dtype=torch.int32)
    arrived = oh.any(1)
    return ring_eff, ring_dur, head, qcnt, dropped, arrived, ring_try


def _preempt_rings(srv, dep, vqof, ring_eff, ring_dur, ring_try, head, qcnt,
                   srv_try, up_t, t, max_requeue, *, J, Qcap):
    """Evict every job resident on a down server, VQS form (batched over G).

    Victims below the retry bound re-enter the TAIL of their own virtual
    queue in row-major ``(server, k-slot)`` order — the same one-hot
    tail-append rule as ``_push_arrivals`` — with their REMAINING duration
    ``dep - t`` and ``tries + 1``; victims past the bound (or whose ring is
    full) are lost.  Returns the updated planes, the slot's
    ``(n_preempted, n_requeued, n_lost)`` counts and the ``re_arrived``
    type mask of rings that received a requeue."""
    G = srv.shape[0]
    nvq = 2 * J
    j_iota = torch.arange(nvq, device=srv.device)
    victim = (~up_t)[..., None] & (srv > 0)                      # (G, L, K)
    elig = (victim & (srv_try < max_requeue)).reshape(G, -1)     # (G, L*K)
    vq = torch.where(elig, vqof.reshape(G, -1), nvq)
    oh = vq[..., None] == j_iota                                 # (G, LK, 2J)
    ohi = oh.to(torch.int32)
    rank = ((torch.cumsum(ohi, 1) - 1) * ohi).sum(-1)
    cnt_own = (ohi * qcnt[:, None, :]).sum(-1)
    head_own = (ohi * head[:, None, :]).sum(-1)
    land = elig & (cnt_own + rank < Qcap)
    pos = (head_own + cnt_own + rank) % Qcap
    rem = torch.clamp_min(dep.reshape(G, -1) - t[:, None], 1)
    ring_eff = _scatter_rows(ring_eff, vq, pos, land, srv.reshape(G, -1))
    ring_dur = _scatter_rows(ring_dur, vq, pos, land, rem)
    ring_try = _scatter_rows(ring_try, vq, pos, land,
                             srv_try.reshape(G, -1) + 1)
    qcnt = qcnt + (oh & land[..., None]).sum(1, dtype=torch.int32)
    re_arrived = (oh & land[..., None]).any(1)
    n_vict = victim.sum((1, 2), dtype=torch.int32)
    n_req = land.sum(1, dtype=torch.int32)
    srv = torch.where(victim, 0, srv)
    dep = torch.where(victim, INF_SLOT, dep)
    vqof = torch.where(victim, -1, vqof)
    srv_try = torch.where(victim, 0, srv_try)
    return (srv, dep, vqof, ring_eff, ring_dur, ring_try, head, qcnt,
            srv_try, n_vict, n_req, n_vict - n_req, re_arrived)


def initial_state(G: int, J: int, L: int, K: int, Qcap: int,
                  device) -> VQSState:
    """Empty cluster, empty rings, slot 0, for G ensemble members."""
    nvq = 2 * J

    def full(shape, v, dtype=torch.int32):
        return torch.full((G, *shape), v, dtype=dtype, device=device)

    z = full((), 0)
    return VQSState(
        srv=full((L, K), 0), dep=full((L, K), INF_SLOT),
        vqof=full((L, K), -1), ring_eff=full((nvq, Qcap), 0),
        ring_dur=full((nvq, Qcap), 1), head=full((nvq,), 0),
        qcnt=full((nvq,), 0), cfg_k1=full((L,), False, torch.bool),
        cfg_js=full((L,), -1), has_cfg=full((L,), False, torch.bool),
        in_empty=full((L,), True, torch.bool),
        want=full((L, nvq), False, torch.bool), t=z, dropped=z,
        truncated=z, ring_try=full((nvq, Qcap), 0), srv_try=full((L, K), 0),
        preempted=z, requeued=z, lost=z,
        up_last=full((L,), True, torch.bool))


def run_vqs_streams(streams: SchedStreams, J: int, L: int, K: int,
                    Qcap: int, A_max: int, work_steps: int | None = None,
                    drain: int | None = None,
                    max_requeue: int = DEFAULT_MAX_REQUEUE,
                    state: VQSState | None = None,
                    return_state: bool = False):
    """Branch-free VQS slot engine over pre-generated streams.

    ``streams`` fields are ``(T, ...)`` for one cluster or ``(G, T, ...)``
    for an ensemble; the result (and the state) has the same leading shape.
    The per-slot serve pass is a work list of at most ``work_steps + 1``
    masked-select steps.  Each step:

      1. evaluates, for every still-pending visited server, whether it
         could place a job under its effective configuration (its own, or —
         for first-touch renewals — the shared max-weight configuration of
         the CURRENT VQ-size vector);
      2. advances past all pending servers below the first placer,
         applying their renewals / ``_empty`` membership / subscription
         writes as one vectorized mask update;
      3. serves the placer: either the single reserved VQ_1 placement, or
         a prefix-fit batch of up to ``drain`` consecutive head-of-VQ_{j*}
         jobs; the placer stays current until it can no longer place.

    A slot that exhausts the step bound with servers still unserved
    increments ``truncated``.  The list stops early once no member has a
    pending server: the remaining steps would change nothing.

    Streams carrying a fault plane run the fault-injected variant
    (``_preempt_rings`` eviction, down servers out of the visit set).
    ``state=`` / ``return_state=True`` thread the complete carry
    (:class:`VQSState`): running the horizon in slices reproduces the
    straight-through trajectory bit for bit; per-slice ``departed`` restarts
    from 0.
    """
    single = streams.n.ndim == 1
    if single:
        streams = _batched(streams)
        if state is not None:
            state = VQSState(*(x[None] for x in state))
    G = streams.n.shape[0]
    if state is None:
        state = initial_state(G, J, L, K, Qcap, streams.n.device)
    P = drain if drain is not None else _default_drain(K, J)
    res, state = _scan(streams, J, L, K, Qcap, A_max,
                       resolve_work_steps(work_steps, A_max), P, max_requeue,
                       state)
    if single:
        res, state = _first(res), _first(state)
    return (res, state) if return_state else res


def _scan(streams: SchedStreams, J: int, L: int, K: int, Qcap: int,
          A_max: int, W: int, P: int, max_requeue: int, state: VQSState):
    n, sizes, durs, up = streams
    G, T = n.shape
    dev = n.device
    nvq = 2 * J
    faulted = up is not None
    confs = k_red_t(J, dev)
    l_iota = torch.arange(L, device=dev)
    j_iota = torch.arange(nvq, device=dev)
    k_iota = torch.arange(K, device=dev)
    p_iota = torch.arange(P, device=dev)
    g_ar = torch.arange(G, device=dev)

    (srv, dep, vqof, ring_eff, ring_dur, head, qcnt, cfg_k1, cfg_js,
     has_cfg, in_empty, want, t, dropped, trunc, ring_try, srv_try,
     preempted, requeued, lost, up_last) = (x.clone() for x in state)
    qlen_out = torch.empty((G, T), dtype=torch.int32, device=dev)
    occ_out = torch.empty((G, T), dtype=torch.int32, device=dev)
    ndep_out = torch.empty((G, T), dtype=torch.int32, device=dev)

    for s_ in range(T):
        up_t = up[:, s_] if faulted else None

        # 1. departures
        leaving = dep == t[:, None, None]
        freed = leaving.any(-1)
        n_dep = leaving.sum((1, 2), dtype=torch.int32)
        srv = torch.where(leaving, 0, srv)
        vqof = torch.where(leaving, -1, vqof)
        dep = torch.where(leaving, INF_SLOT, dep)

        # 1b. capacity shocks: evict down servers into the VQ tails,
        # recoveries count as freed, down servers leave the visit set.
        re_arrived = None
        if faulted:
            srv_try = torch.where(leaving, 0, srv_try)
            (srv, dep, vqof, ring_eff, ring_dur, ring_try, head, qcnt,
             srv_try, n_p, n_r, n_l, re_arrived) = _preempt_rings(
                srv, dep, vqof, ring_eff, ring_dur, ring_try, head, qcnt,
                srv_try, up_t, t, max_requeue, J=J, Qcap=Qcap)
            preempted = preempted + n_p
            requeued = requeued + n_r
            lost = lost + n_l
            freed = (freed | (up_t & ~up_last)) & up_t
            up_last = up_t
        empty_now = (srv > 0).sum(-1) == 0

        # 2. arrivals
        (ring_eff, ring_dur, head, qcnt, dropped, arrived,
         rt) = _push_arrivals(ring_eff, ring_dur, head, qcnt, dropped,
                              n[:, s_], sizes[:, s_], durs[:, s_], J=J,
                              Qcap=Qcap, A_max=A_max,
                              ring_try=ring_try if faulted else None)
        if faulted:
            ring_try = rt
            arrived = arrived | re_arrived

        # 3. visit set
        woken = (want & arrived[:, None, :]).any(-1)
        want = want & ~arrived[:, None, :]
        visit = freed | woken | (in_empty & (qcnt.sum(-1) > 0)[:, None])
        if faulted:
            visit = visit & up_t
        renew_needed = visit & (empty_now | ~has_cfg)

        # 4. bounded work list (see run_vqs_streams)
        touched = torch.zeros((G, L), dtype=torch.bool, device=dev)
        advanced = torch.zeros_like(touched)
        for _ in range(W + 1):
            pending = visit & ~advanced
            if not bool(pending.any()):
                break  # every remaining step is a no-op for every member
            hx = qcnt > 0
            head_effs = torch.gather(ring_eff, 2,
                                     (head % Qcap)[..., None].long())[..., 0]

            # shared renewal candidate + per-server effective configuration
            r_k1, r_js = _mw_config(confs, qcnt, J)
            ren = renew_needed & ~touched
            eff_k1 = torch.where(ren, r_k1[:, None], cfg_k1)
            eff_js = torch.where(ren, r_js[:, None], cfg_js)

            occ = srv.sum(-1, dtype=torch.int32)
            is1 = (vqof == 1) & (srv > 0)
            vq1_occ = (srv * is1).sum(-1, dtype=torch.int32)
            has_vq1 = is1.any(-1)
            resid = CAP - occ
            other_occ = occ - vq1_occ
            other_cap = torch.where(eff_k1, CAP - RESERVE, CAP)
            k1_can = eff_k1 & ~has_vq1 & hx[:, 1:2] \
                & (head_effs[:, 1:2] <= resid)
            js_oh = eff_js[..., None] == j_iota                 # (G, L, 2J)
            js_head = (js_oh * head_effs[:, None, :]).sum(-1,
                                                           dtype=torch.int32)
            js_ex = (js_oh & hx[:, None, :]).any(-1)
            js_can = (eff_js >= 0) & js_ex & (other_occ + js_head <= other_cap)
            would = pending & (k1_can | js_can)

            placer = torch.where(would, l_iota, L).amin(-1)      # (G,)
            tch = pending & (l_iota <= placer[:, None])
            adv = pending & (l_iota < placer[:, None])

            do_ren = tch & ren
            cfg_k1 = torch.where(do_ren, r_k1[:, None], cfg_k1)
            cfg_js = torch.where(do_ren, r_js[:, None], cfg_js)
            has_cfg = has_cfg | tch
            # _empty membership is granted at FIRST touch only (numpy adds
            # at visit time, before serving): a placer that emptied at slot
            # start but placed jobs in earlier steps must not be re-marked
            # from the stale empty_now mask when it is advanced past.
            in_empty = in_empty | (tch & ~touched & empty_now)
            touched = touched | tch
            advanced = advanced | adv

            # subscriptions of the servers advanced past
            sub1 = adv & eff_k1 & ~has_vq1 & ~hx[:, 1:2]
            subj = adv & (eff_js >= 0) & ~js_ex
            want = want | (sub1[..., None] & (j_iota == 1)) \
                | (subj[..., None] & js_oh)

            # serve the placer
            any_p = placer < L
            s = torch.clamp_max(placer, L - 1)
            do_k1 = any_p & k1_can[g_ar, s]
            j_sel = torch.where(do_k1, 1, torch.clamp_min(eff_js[g_ar, s], 0)
                                ).long()
            wpos = ((head[g_ar, j_sel][:, None] + p_iota) % Qcap).long()
            effs_w = ring_eff[g_ar[:, None], j_sel[:, None], wpos]  # (G, P)
            durs_w = ring_dur[g_ar[:, None], j_sel[:, None], wpos]
            in_q = p_iota < qcnt[g_ar, j_sel][:, None]
            budget = other_cap[g_ar, s] - other_occ[g_ar, s]
            fit = in_q & (torch.cumsum(effs_w, 1) <= budget[:, None])
            m = torch.where(do_k1, 1, fit.sum(-1, dtype=torch.int32))
            m = torch.where(any_p, m, 0).to(torch.int32)

            row = srv[g_ar, s]
            es = row == 0
            free_cnt = es.sum(-1, dtype=torch.int32)
            slotrank = torch.cumsum(es.to(torch.int32), -1) - 1
            sel = (es[..., None] & (slotrank[..., None] == p_iota)
                   & (p_iota < m[:, None])[:, None, :])         # (G, K, P)
            seli = sel.to(torch.int32)
            placed_k = sel.any(-1)
            srv[g_ar, s] = row + (seli * effs_w[:, None, :]).sum(
                -1, dtype=torch.int32)
            dep[g_ar, s] = torch.where(
                placed_k, t[:, None] + (seli * durs_w[:, None, :]).sum(
                    -1, dtype=torch.int32),
                dep[g_ar, s])
            vqof[g_ar, s] = torch.where(placed_k, j_sel[:, None].int(),
                                        vqof[g_ar, s])
            if faulted:  # retry counts ride with the placed jobs
                tries_w = ring_try[g_ar[:, None], j_sel[:, None], wpos]
                srv_try[g_ar, s] = torch.where(
                    placed_k, (seli * tries_w[:, None, :]).sum(
                        -1, dtype=torch.int32),
                    srv_try[g_ar, s])
            head[g_ar, j_sel] += m
            qcnt[g_ar, j_sel] -= m
            in_empty = in_empty & ~((l_iota == placer[:, None])
                                    & (m > 0)[:, None])
            trunc = trunc + torch.clamp_min(m - free_cnt, 0)  # K-overflow
        # cap hit with servers still unserved: the slot finished lazily
        trunc = trunc + (visit & ~advanced).any(-1).to(torch.int32)

        qlen_out[:, s_] = qcnt.sum(-1, dtype=torch.int32)
        occ_out[:, s_] = srv.sum((1, 2), dtype=torch.int32)
        ndep_out[:, s_] = n_dep
        t = t + 1

    state = VQSState(srv, dep, vqof, ring_eff, ring_dur, head, qcnt, cfg_k1,
                     cfg_js, has_cfg, in_empty, want, t, dropped, trunc,
                     ring_try, srv_try, preempted, requeued, lost, up_last)
    # occupancy: the int32 grid sum in float32, over RES (exact scaling)
    res = PolicyResult(qlen_out, occ_out.to(torch.float32) / RES,
                       torch.cumsum(ndep_out, 1, dtype=torch.int32),
                       dropped, trunc, preempted, requeued, lost)
    return res, state


def _cuda_ok(streams: SchedStreams, J: int, L: int, K: int, Qcap: int,
             A_max: int, strict: bool) -> bool:
    """The kernel gate: a fault plane, or a block over the shared-memory
    limit, gives way to the scan engine.  The block's size is read from
    the built kernel, so only for card tensors: on the CPU the wrapper runs
    the plain version."""
    from ...kernels.common import cuda_precheck
    from ...kernels.vqs.ops import vqs_scratch_bytes
    fault = streams.up is not None
    on_card = not fault and streams.n.device.type == "cuda"
    return cuda_precheck(
        "vqs", nbytes=vqs_scratch_bytes(J, L, K, Qcap, A_max) if on_card
        else 0, fault_plane=fault, strict=strict)


def run_vqs_trace(streams: SchedStreams, *, J: int, L: int, K: int,
                  Qcap: int, A_max: int, engine: str = "scan",
                  work_steps: int | None = None, drain: int | None = None,
                  window: int | None = None,
                  max_requeue: int = DEFAULT_MAX_REQUEUE,
                  strict: bool = False) -> PolicyResult:
    """Run VQS over explicit streams (random or trace-built; one cluster, or
    an ensemble with a leading G axis) on the streams' device.  ``window``
    is validated against the horizon for ``engine="cuda"``."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    if engine == "cuda":
        if _cuda_ok(streams, J, L, K, Qcap, A_max, strict):
            from ...kernels.vqs.ops import vqs_simulate
            single = streams.n.ndim == 1
            res = vqs_simulate(_batched(streams) if single else streams,
                               J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                               work_steps=work_steps, drain=drain,
                               window=window)
            return _first(res) if single else res
        engine = "scan"
    if engine == "scan":
        return run_vqs_streams(streams, J=J, L=L, K=K, Qcap=Qcap,
                               A_max=A_max, work_steps=work_steps,
                               drain=drain, max_requeue=max_requeue)
    raise ValueError(f"unknown engine {engine!r}; expected one of "
                     f"{', '.join(ENGINES)}")


def run_vqs(seed: int, lam: float, mu: float, sampler: Callable,
            J: int = 4, L: int = 8, K: int = 16, Qcap: int = 512,
            A_max: int = 8, horizon: int = 10_000, engine: str = "scan",
            work_steps: int | None = None, drain: int | None = None,
            window: int | None = None, fault_rate: float = 0.0,
            repair_rate: float = 1.0,
            max_requeue: int = DEFAULT_MAX_REQUEUE, strict: bool = False,
            device=None) -> PolicyResult:
    """Simulate VQS on L unit-capacity servers for ``horizon`` slots.

    ``seed`` seeds the stream generator on ``device`` (default: the card);
    service durations attach to jobs at arrival.  ``fault_rate > 0``
    injects per-slot server capacity shocks: down servers evict their jobs
    into the tails of their virtual queues (up to ``max_requeue`` retries
    each, ``lost`` past that)."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    streams = make_streams(gen, lam, mu, sampler, L=L, K=K, A_max=A_max,
                           horizon=horizon, device=device,
                           fault_rate=fault_rate, repair_rate=repair_rate)
    return run_vqs_trace(streams, J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                         engine=engine, work_steps=work_steps, drain=drain,
                         window=window, max_requeue=max_requeue,
                         strict=strict)


def monte_carlo_vqs(seeds, lam: float, mu: float, sampler: Callable,
                    engine: str = "scan", work_steps: int | None = None,
                    drain: int | None = None, window: int | None = None,
                    J: int = 4, L: int = 8, K: int = 16, Qcap: int = 512,
                    A_max: int = 8, horizon: int = 10_000,
                    fault_rate: float = 0.0, repair_rate: float = 1.0,
                    max_requeue: int = DEFAULT_MAX_REQUEUE,
                    strict: bool = False, device=None) -> PolicyResult:
    """One simulated cluster per integer seed, batched on a leading G axis
    ("cuda": one thread block per member)."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    device = resolve_device(device)
    streams = ensemble_streams(seeds, lam, mu, sampler, L=L, K=K,
                               A_max=A_max, horizon=horizon, device=device,
                               fault_rate=fault_rate,
                               repair_rate=repair_rate)
    return run_vqs_trace(streams, J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                         engine=engine, work_steps=work_steps, drain=drain,
                         window=window, max_requeue=max_requeue,
                         strict=strict)


def run_vqs_workload(workload, seed: int = 0, *, engine: str = "scan",
                     **config) -> PolicyResult:
    """Workload-first adapter: the registry entry behind
    ``run_policy(workload, policy="vqs", ...)``.  VQS partitions scalar
    sizes; vector workloads are rejected loudly."""
    workload.require_scalar("vqs")
    workload.check_sampler()
    return run_vqs(seed, workload.lam, workload.mu, workload.sampler,
                   engine=engine, **config)


def monte_carlo_vqs_workload(workload, seeds, *, engine: str = "scan",
                             **config) -> PolicyResult:
    """Workload-first adapter for ``monte_carlo_policy(policy="vqs")``."""
    workload.require_scalar("vqs")
    workload.check_sampler()
    return monte_carlo_vqs(seeds, workload.lam, workload.mu,
                           workload.sampler, engine=engine, **config)
