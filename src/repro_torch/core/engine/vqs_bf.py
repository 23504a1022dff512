"""VQS-BF cluster engines (paper Section VI, Theorem 4: the VQS 2/3
throughput guarantee with BF-like delay), torch port of
``repro.core.engine.vqs_bf``.

VQS-BF keeps VQS's configuration machinery (max-weight renewal at
server-empty epochs, subscription wake-ups) but replaces head-of-queue
FIFO service with LARGEST-fit-first pops and adds two Best-Fit passes:

  (i)   with k_1 = 1 the server takes the largest fitting VQ_1 job,
        reserving exactly that job's size;
  (ii)  the other configured type j* is served largest-fit-first from the
        FULL residual, stopping at k_{j*} resident jobs of that type;
  (iii) the remaining capacity is swept BF-S style: keep taking the
        largest fitting job over ALL virtual queues until nothing fits;
  (iv)  an arrival-side BF-J pass offers every still-queued arrival of the
        slot to the tightest feasible server.

The largest-fit-first multiset is per-VQ size-bucketed rings: one
``(2J, Qcap)`` effective-size plane with first-empty-slot allocation (pops
punch holes; pushes fill the lowest hole), plus a monotone arrival-sequence
plane, so "pop the largest job <= cap" is a masked lexicographic reduction
— maximum effective size, then lowest VQ index, then smallest sequence
stamp (FIFO among equals).

Engines: ``engine="scan"`` (the branch-free bounded work list, batched over
a leading ensemble axis G; each step advances past every pending visited
server that cannot place and serves the first one that can with ONE
pop-and-place) and ``engine="cuda"`` (the fused kernel in
``kernels/vqs_bf``).  Both equal the JAX ``run_vqs_bf_streams`` on every
field of shared streams.  Ring overflow is counted in ``dropped``,
per-server K-slot overflow and lazily-finished slots in ``truncated``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...device import resolve_device
from ..quantize import RES
from .bfjs import DEFAULT_MAX_REQUEUE, _batched, _first, ensemble_streams
from .ops import k_red_t, max_weight_config, to_grid_t, vq_type_of_grid
from .streams import (INF_SLOT, PolicyResult, SchedStreams, make_streams,
                      resolve_work_steps)
from .vqs import ENGINES, _REFERENCE_TODO, _scatter_rows

CAP = RES
_INF32 = 2 ** 31 - 1


class VQSBFState(NamedTuple):
    """The complete carry of the VQS-BF scan engine, in the order of the
    JAX package's scan carry (``run_vqs_bf_streams(...,
    return_state=True)``).  Batched runs carry a leading G axis."""
    srv: torch.Tensor        # (L, K) i32 effective sizes (0 = empty)
    dep: torch.Tensor        # (L, K) i32 departure slot (INF_SLOT if empty)
    vqof: torch.Tensor       # (L, K) i32 VQ type of the job (-1 if empty)
    ring_eff: torch.Tensor   # (2J, Qcap) i32 bucketed sizes (0 = hole)
    ring_dur: torch.Tensor   # (2J, Qcap) i32 durations
    ring_seq: torch.Tensor   # (2J, Qcap) i32 sequence stamps
    qcnt: torch.Tensor       # (2J,) i32 queued jobs per VQ
    seq_ctr: torch.Tensor    # () i32 next sequence stamp
    cfg_k1: torch.Tensor     # (L,) bool
    cfg_js: torch.Tensor     # (L,) i32 (-1 if none)
    cfg_ks: torch.Tensor     # (L,) i32 k_{j*} cap
    has_cfg: torch.Tensor    # (L,) bool
    in_empty: torch.Tensor   # (L,) bool
    want: torch.Tensor       # (L, 2J) bool subscriptions
    t: torch.Tensor          # () i32
    dropped: torch.Tensor    # () i32
    truncated: torch.Tensor  # () i32
    ring_try: torch.Tensor   # (2J, Qcap) i32
    srv_try: torch.Tensor    # (L, K) i32
    preempted: torch.Tensor  # () i32
    requeued: torch.Tensor   # () i32
    lost: torch.Tensor       # () i32
    up_last: torch.Tensor    # (L,) bool


def _decode_config_bf(row: torch.Tensor, J: int):
    """(k1, jstar, kstar) of K_RED rows ``(..., 2J)`` — ``VQS._set_config``
    plus the k_{j*} cap that VQS-BF's step (ii) enforces."""
    nvq = 2 * J
    j_iota = torch.arange(nvq, device=row.device)
    k1 = row[..., 1] > 0
    js = torch.where((row > 0) & (j_iota != 1), j_iota, nvq).amin(-1)
    jsx = torch.clamp_max(js, nvq - 1)
    ks = torch.where(js < nvq, torch.gather(row, -1, jsx[..., None])[..., 0],
                     0).to(torch.int32)
    return k1, torch.where(js == nvq, -1, js).to(torch.int32), ks


def _mw_config_bf(confs: torch.Tensor, qcnt: torch.Tensor, J: int):
    """First-index max-weight row over K_RED (paper Eq. 8), decoded."""
    return _decode_config_bf(max_weight_config(confs, qcnt)[1], J)


def _pop_largest(ring_eff, ring_seq, rows_ok, cap):
    """Locate the pop of ``VirtualQueues.pop_largest_leq_any`` restricted to
    ``rows_ok (G, 2J)``: maximum effective size <= ``cap (G,)``, ties to
    the lowest VQ index, FIFO among equals via the smallest sequence stamp.
    Returns ``(found, vq, pos)`` (G,) with clamped in-range indices when
    not found."""
    G, nvq, Qcap = ring_eff.shape
    dev = ring_eff.device
    j_iota = torch.arange(nvq, device=dev)
    q_iota = torch.arange(Qcap, device=dev)
    g_ar = torch.arange(G, device=dev)
    elig = (ring_eff > 0) & rows_ok[..., None] \
        & (ring_eff <= cap[:, None, None])
    best_eff = torch.where(elig, ring_eff, 0).amax((1, 2))
    cand = elig & (ring_eff == best_eff[:, None, None])
    vq = torch.where(cand.any(-1), j_iota, nvq).amin(-1)
    found = vq < nvq
    vqc = torch.clamp_max(vq, nvq - 1)
    row_cand = cand[g_ar, vqc]
    seq_row = ring_seq[g_ar, vqc]
    best_seq = torch.where(row_cand, seq_row, _INF32).amin(-1)
    pos = torch.where(row_cand & (seq_row == best_seq[:, None]), q_iota,
                      Qcap).amin(-1)
    return found, vqc, torch.clamp_max(pos, Qcap - 1)


def _first_empty_in_rows(ring_eff, vq, rank):
    """Position of the ``rank``-th (0-based) empty slot of row ``vq`` of a
    batched ``(G, 2J, Qcap)`` ring plane, for ``(G, N)`` requests; also the
    number of empty slots of that row.  Positions of requests past the
    row's empties are clamped to ``Qcap - 1``."""
    G, nvq, Qcap = ring_eff.shape
    q_iota = torch.arange(Qcap, device=ring_eff.device)
    g_ar = torch.arange(G, device=ring_eff.device)[:, None]
    emp = ring_eff == 0
    erank = torch.cumsum(emp.to(torch.int32), -1) - 1            # (G,2J,Q)
    empty_cnt = emp.sum(-1, dtype=torch.int32)                   # (G, 2J)
    sel = emp[g_ar, vq] & (erank[g_ar, vq] == rank[..., None])   # (G,N,Q)
    pos = torch.clamp_max(torch.where(sel, q_iota, Qcap).amin(-1), Qcap - 1)
    return pos, empty_cnt[g_ar, vq]


def _push_arrivals_bf(ring_eff, ring_dur, ring_seq, qcnt, dropped, seq_ctr,
                      n_t, sizes_t, durs_t, *, J, Qcap, A_max,
                      ring_try=None):
    """Classify + bucket one slot's arrivals (batched over G, order-exact).

    Every arrival lands in the lowest empty slot of its VQ's bucket ring
    (lane order within the slot — the rank-into-empty-slots scatter is
    exactly A_max sequential first-empty pushes) and is stamped with a
    monotone sequence number.  Arrivals whose bucket is full are dropped
    and counted.  Returns the per-lane ``(vq, pos, seq, eff, dur,
    landed)`` records the slot's arrival-side BF-J pass keys on."""
    nvq = 2 * J
    dev = n_t.device
    a_iota = torch.arange(A_max, device=dev)
    j_iota = torch.arange(nvq, device=dev)
    g = to_grid_t(sizes_t)
    vq = vq_type_of_grid(g, J)
    eff = torch.where(vq == nvq - 1, torch.clamp_min(g, RES >> J), g)
    dur = durs_t[:, durs_t.shape[1] - A_max:]
    valid = a_iota < n_t[:, None]
    oh = (vq[..., None] == j_iota) & valid[..., None]            # (G, A, 2J)
    ohi = oh.to(torch.int32)
    rank = ((torch.cumsum(ohi, 1) - 1) * ohi).sum(-1)
    pos, empty_cnt = _first_empty_in_rows(ring_eff, vq.long(), rank)
    land = valid & (rank < empty_cnt)
    seq = seq_ctr[:, None] + a_iota.to(torch.int32)
    ring_eff = _scatter_rows(ring_eff, vq, pos, land, eff)
    ring_dur = _scatter_rows(ring_dur, vq, pos, land, dur)
    ring_seq = _scatter_rows(ring_seq, vq, pos, land, seq)
    if ring_try is not None:
        ring_try = _scatter_rows(ring_try, vq, pos, land,
                                 torch.zeros_like(eff))
    qcnt = qcnt + (oh & land[..., None]).sum(1, dtype=torch.int32)
    dropped = dropped + (valid & ~land).sum(1, dtype=torch.int32)
    arrived = oh.any(1)
    lanes = (vq, pos, seq, eff, dur, land)
    return (ring_eff, ring_dur, ring_seq, qcnt, dropped, seq_ctr + A_max,
            arrived, ring_try, lanes)


def _preempt_rings_bf(srv, dep, vqof, ring_eff, ring_dur, ring_seq, ring_try,
                      qcnt, seq_ctr, srv_try, up_t, t, max_requeue, *, J,
                      Qcap):
    """Evict every job resident on a down server, VQS-BF form (batched over
    G): victims below the retry bound re-enter their own bucket ring in
    row-major ``(server, k-slot)`` order — first-empty slots, fresh
    sequence stamps — with their REMAINING duration and ``tries + 1``;
    victims past the bound or whose bucket is full are lost."""
    G, L, K = srv.shape
    nvq = 2 * J
    dev = srv.device
    j_iota = torch.arange(nvq, device=dev)
    victim = (~up_t)[..., None] & (srv > 0)
    elig = (victim & (srv_try < max_requeue)).reshape(G, -1)
    vq = torch.where(elig, vqof.reshape(G, -1), nvq)
    vqc = torch.clamp_max(vq, nvq - 1)
    oh = vq[..., None] == j_iota
    ohi = oh.to(torch.int32)
    rank = ((torch.cumsum(ohi, 1) - 1) * ohi).sum(-1)
    pos, empty_cnt = _first_empty_in_rows(ring_eff, vqc.long(), rank)
    land = elig & (rank < empty_cnt)
    rem = torch.clamp_min(dep.reshape(G, -1) - t[:, None], 1)
    seq = seq_ctr[:, None] + torch.arange(L * K, device=dev,
                                          dtype=torch.int32)
    ring_eff = _scatter_rows(ring_eff, vq, pos, land, srv.reshape(G, -1))
    ring_dur = _scatter_rows(ring_dur, vq, pos, land, rem)
    ring_seq = _scatter_rows(ring_seq, vq, pos, land, seq)
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
    return (srv, dep, vqof, ring_eff, ring_dur, ring_seq, ring_try, qcnt,
            seq_ctr + L * K, srv_try, n_vict, n_req, n_vict - n_req,
            re_arrived)


def _place(srv, dep, vqof, srv_try, s, do, eff, dur, vq, t, tries=None):
    """Put one job into the first empty K-slot of server ``s`` for the
    members where ``do``; a full row writes nothing.  Returns the planes
    and the ``ok`` mask (a free slot existed)."""
    K = srv.shape[2]
    g_ar = torch.arange(srv.shape[0], device=srv.device)
    k_iota = torch.arange(K, device=srv.device)
    row = srv[g_ar, s]
    kfree = torch.where(row == 0, k_iota, K).amin(-1)
    ok = kfree < K
    hit = (k_iota == kfree[:, None]) & (do & ok)[:, None]        # (G, K)
    srv[g_ar, s] = torch.where(hit, eff[:, None], row)
    dep[g_ar, s] = torch.where(hit, (t + dur)[:, None], dep[g_ar, s])
    vqof[g_ar, s] = torch.where(hit, vq[:, None].to(torch.int32),
                                vqof[g_ar, s])
    if tries is not None:
        srv_try[g_ar, s] = torch.where(hit, tries[:, None], srv_try[g_ar, s])
    return ok


def _arrival_bf_pass(srv, dep, vqof, ring_eff, ring_seq, qcnt, in_empty,
                     srv_try, trunc, t, lanes, up_t, *, L, K, A_max,
                     faulted):
    """The slot's closing BF-J pass (``VQSBF.schedule`` tail): each arrival
    still sitting in its bucket (its sequence stamp survived the serve
    pass) goes to the tightest feasible server — minimum residual >= size,
    ties to the smallest server id.  Sequential over the A_max lanes."""
    a_vq, a_pos, a_seq, a_eff, a_dur, a_land = lanes
    G = srv.shape[0]
    dev = srv.device
    g_ar = torch.arange(G, device=dev)
    l_iota = torch.arange(L, device=dev)
    for a in range(A_max):
        vq_a, pos_a = a_vq[:, a].long(), a_pos[:, a]
        queued = a_land[:, a] & (ring_eff[g_ar, vq_a, pos_a] > 0) \
            & (ring_seq[g_ar, vq_a, pos_a] == a_seq[:, a])
        resid = CAP - srv.sum(-1, dtype=torch.int32)
        cand = resid >= a_eff[:, a:a + 1]
        if faulted:
            cand = cand & up_t
        rbest = torch.where(cand, resid, _INF32).amin(-1)
        s = torch.where(cand & (resid == rbest[:, None]), l_iota, L).amin(-1)
        do = queued & (s < L)
        sc = torch.clamp_max(s, L - 1)
        ok = _place(srv, dep, vqof, srv_try, sc, do, a_eff[:, a],
                    a_dur[:, a], vq_a, t,
                    torch.zeros_like(a_eff[:, a]) if faulted else None)
        ring_eff[g_ar, vq_a, pos_a] = torch.where(
            do, 0, ring_eff[g_ar, vq_a, pos_a])
        qcnt[g_ar, vq_a] -= do.to(torch.int32)
        trunc = trunc + (do & ~ok).to(torch.int32)
        in_empty = in_empty & ~((l_iota == s[:, None]) & do[:, None])
    return srv, dep, vqof, ring_eff, qcnt, in_empty, srv_try, trunc


def initial_state(G: int, J: int, L: int, K: int, Qcap: int,
                  device) -> VQSBFState:
    """Empty cluster, empty buckets, slot 0, for G ensemble members."""
    nvq = 2 * J

    def full(shape, v, dtype=torch.int32):
        return torch.full((G, *shape), v, dtype=dtype, device=device)

    z = full((), 0)
    return VQSBFState(
        srv=full((L, K), 0), dep=full((L, K), INF_SLOT),
        vqof=full((L, K), -1), ring_eff=full((nvq, Qcap), 0),
        ring_dur=full((nvq, Qcap), 1), ring_seq=full((nvq, Qcap), 0),
        qcnt=full((nvq,), 0), seq_ctr=z,
        cfg_k1=full((L,), False, torch.bool), cfg_js=full((L,), -1),
        cfg_ks=full((L,), 0), has_cfg=full((L,), False, torch.bool),
        in_empty=full((L,), True, torch.bool),
        want=full((L, nvq), False, torch.bool), t=z, dropped=z,
        truncated=z, ring_try=full((nvq, Qcap), 0), srv_try=full((L, K), 0),
        preempted=z, requeued=z, lost=z,
        up_last=full((L,), True, torch.bool))


def run_vqs_bf_streams(streams: SchedStreams, J: int, L: int, K: int,
                       Qcap: int, A_max: int, work_steps: int | None = None,
                       max_requeue: int = DEFAULT_MAX_REQUEUE,
                       state: VQSBFState | None = None,
                       return_state: bool = False):
    """Branch-free VQS-BF slot engine over pre-generated streams.

    ``streams`` fields are ``(T, ...)`` or ``(G, T, ...)``; the result (and
    the state) has the same leading shape.  The per-slot serve pass is a
    work list of at most ``work_steps + 1`` masked-select steps.  Each
    step:

      1. evaluates, for every still-pending visited server, whether it
         could place a job under its effective configuration — step (i)
         when a VQ_1 job fits and none is resident, step (ii) when a
         VQ_{j*} job fits below the k_{j*} cap, step (iii) when ANY queued
         job fits (per-bucket minimum queued sizes against the residual);
      2. advances past all pending servers below the first placer,
         applying renewals / ``_empty`` membership / subscriptions as one
         vectorized mask write;
      3. serves the placer with ONE largest-fit pop-and-place, re-staged
         (i) -> (ii) -> (iii) every step from the post-placement state.

    After the work list the slot closes with the arrival-side BF-J pass.
    The list stops early once no member has a pending server.  Streams
    carrying a fault plane run the fault-injected variant.  ``state=`` /
    ``return_state=True`` thread the complete carry (:class:`VQSBFState`).
    """
    single = streams.n.ndim == 1
    if single:
        streams = _batched(streams)
        if state is not None:
            state = VQSBFState(*(x[None] for x in state))
    G = streams.n.shape[0]
    if state is None:
        state = initial_state(G, J, L, K, Qcap, streams.n.device)
    res, state = _scan(streams, J, L, K, Qcap, A_max,
                       resolve_work_steps(work_steps, A_max), max_requeue,
                       state)
    if single:
        res, state = _first(res), _first(state)
    return (res, state) if return_state else res


def _scan(streams: SchedStreams, J: int, L: int, K: int, Qcap: int,
          A_max: int, W: int, max_requeue: int, state: VQSBFState):
    n, sizes, durs, up = streams
    G, T = n.shape
    dev = n.device
    nvq = 2 * J
    faulted = up is not None
    confs = k_red_t(J, dev)
    l_iota = torch.arange(L, device=dev)
    j_iota = torch.arange(nvq, device=dev)
    g_ar = torch.arange(G, device=dev)

    (srv, dep, vqof, ring_eff, ring_dur, ring_seq, qcnt, seq_ctr, cfg_k1,
     cfg_js, cfg_ks, has_cfg, in_empty, want, t, dropped, trunc, ring_try,
     srv_try, preempted, requeued, lost, up_last) = (x.clone() for x in state)
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

        # 1b. capacity shocks (shared _preempt_rings_bf rule)
        re_arrived = None
        if faulted:
            srv_try = torch.where(leaving, 0, srv_try)
            (srv, dep, vqof, ring_eff, ring_dur, ring_seq, ring_try, qcnt,
             seq_ctr, srv_try, n_p, n_r, n_l, re_arrived) = _preempt_rings_bf(
                srv, dep, vqof, ring_eff, ring_dur, ring_seq, ring_try, qcnt,
                seq_ctr, srv_try, up_t, t, max_requeue, J=J, Qcap=Qcap)
            preempted = preempted + n_p
            requeued = requeued + n_r
            lost = lost + n_l
            freed = (freed | (up_t & ~up_last)) & up_t
            up_last = up_t
        empty_now = (srv > 0).sum(-1) == 0

        # 2. arrivals
        (ring_eff, ring_dur, ring_seq, qcnt, dropped, seq_ctr, arrived, rt,
         lanes) = _push_arrivals_bf(
            ring_eff, ring_dur, ring_seq, qcnt, dropped, seq_ctr, n[:, s_],
            sizes[:, s_], durs[:, s_], J=J, Qcap=Qcap, A_max=A_max,
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

        # 4. bounded work list (see run_vqs_bf_streams)
        touched = torch.zeros((G, L), dtype=torch.bool, device=dev)
        advanced = torch.zeros_like(touched)
        for _ in range(W + 1):
            pending = visit & ~advanced
            if not bool(pending.any()):
                break  # every remaining step is a no-op for every member
            hx = qcnt > 0
            row_min = torch.where(ring_eff > 0, ring_eff, _INF32).amin(-1)
            glob_min = row_min.amin(-1)

            # shared renewal candidate + per-server effective configuration
            r_k1, r_js, r_ks = _mw_config_bf(confs, qcnt, J)
            ren = renew_needed & ~touched
            eff_k1 = torch.where(ren, r_k1[:, None], cfg_k1)
            eff_js = torch.where(ren, r_js[:, None], cfg_js)
            eff_ks = torch.where(ren, r_ks[:, None], cfg_ks)

            resid = CAP - srv.sum(-1, dtype=torch.int32)
            has_vq1 = ((vqof == 1) & (srv > 0)).any(-1)
            js_oh = eff_js[..., None] == j_iota                 # (G, L, 2J)
            js_min = torch.where(js_oh, row_min[:, None, :], _INF32).amin(-1)
            js_ex = (js_oh & hx[:, None, :]).any(-1)
            cnt_js = ((vqof == eff_js[..., None]) & (srv > 0)).sum(
                -1, dtype=torch.int32)

            k1_can = eff_k1 & ~has_vq1 & (row_min[:, 1:2] <= resid)
            js_can = (eff_js >= 0) & (cnt_js < eff_ks) & (js_min <= resid)
            any_can = glob_min[:, None] <= resid
            would = pending & (k1_can | js_can | any_can)

            placer = torch.where(would, l_iota, L).amin(-1)
            tch = pending & (l_iota <= placer[:, None])
            adv = pending & (l_iota < placer[:, None])

            do_ren = tch & ren
            cfg_k1 = torch.where(do_ren, r_k1[:, None], cfg_k1)
            cfg_js = torch.where(do_ren, r_js[:, None], cfg_js)
            cfg_ks = torch.where(do_ren, r_ks[:, None], cfg_ks)
            has_cfg = has_cfg | tch
            # _empty membership is granted at FIRST touch only (numpy adds
            # at visit time, before serving) — see engine/vqs.py.
            in_empty = in_empty | (tch & ~touched & empty_now)
            touched = touched | tch
            advanced = advanced | adv

            # subscriptions of the servers advanced past
            sub1 = adv & eff_k1 & ~has_vq1 & ~hx[:, 1:2]
            subj = adv & (eff_js >= 0) & (cnt_js < eff_ks) & ~js_ex
            want = want | (sub1[..., None] & (j_iota == 1)) \
                | (subj[..., None] & js_oh)

            # serve the placer: one largest-fit pop-and-place, staged
            # (i) -> (ii) -> (iii)
            any_p = placer < L
            s = torch.clamp_max(placer, L - 1)
            do1 = k1_can[g_ar, s]
            doj = ~do1 & js_can[g_ar, s]
            rows_ok = torch.where(
                do1[:, None], j_iota == 1,
                torch.where(doj[:, None],
                            j_iota == torch.clamp_min(eff_js[g_ar, s],
                                                      0)[:, None], True))
            found, pvq, ppos = _pop_largest(ring_eff, ring_seq, rows_ok,
                                            resid[g_ar, s])
            do_place = any_p & found
            ok = _place(srv, dep, vqof, srv_try, s, do_place,
                        ring_eff[g_ar, pvq, ppos], ring_dur[g_ar, pvq, ppos],
                        pvq, t,
                        ring_try[g_ar, pvq, ppos] if faulted else None)
            ring_eff[g_ar, pvq, ppos] = torch.where(
                do_place, 0, ring_eff[g_ar, pvq, ppos])
            qcnt[g_ar, pvq] -= do_place.to(torch.int32)
            trunc = trunc + (do_place & ~ok).to(torch.int32)  # K-overflow
            in_empty = in_empty & ~((l_iota == placer[:, None])
                                    & do_place[:, None])
        # cap hit with servers still unserved: the slot finished lazily
        trunc = trunc + (visit & ~advanced).any(-1).to(torch.int32)

        # 5. arrival-side BF-J pass over jobs still queued
        (srv, dep, vqof, ring_eff, qcnt, in_empty, srv_try,
         trunc) = _arrival_bf_pass(
            srv, dep, vqof, ring_eff, ring_seq, qcnt, in_empty, srv_try,
            trunc, t, lanes, up_t, L=L, K=K, A_max=A_max, faulted=faulted)

        qlen_out[:, s_] = qcnt.sum(-1, dtype=torch.int32)
        occ_out[:, s_] = srv.sum((1, 2), dtype=torch.int32)
        ndep_out[:, s_] = n_dep
        t = t + 1

    state = VQSBFState(srv, dep, vqof, ring_eff, ring_dur, ring_seq, qcnt,
                       seq_ctr, cfg_k1, cfg_js, cfg_ks, has_cfg, in_empty,
                       want, t, dropped, trunc, ring_try, srv_try, preempted,
                       requeued, lost, up_last)
    res = PolicyResult(qlen_out, occ_out.to(torch.float32) / RES,
                       torch.cumsum(ndep_out, 1, dtype=torch.int32),
                       dropped, trunc, preempted, requeued, lost)
    return res, state


def _cuda_ok(streams: SchedStreams, J: int, L: int, K: int, Qcap: int,
             A_max: int, strict: bool) -> bool:
    """The kernel gate of ``vqs._cuda_ok``, for the VQS-BF kernel."""
    from ...kernels.common import cuda_precheck
    from ...kernels.vqs_bf.ops import vqs_bf_scratch_bytes
    fault = streams.up is not None
    on_card = not fault and streams.n.device.type == "cuda"
    return cuda_precheck(
        "vqs_bf", nbytes=vqs_bf_scratch_bytes(J, L, K, Qcap, A_max)
        if on_card else 0, fault_plane=fault, strict=strict)


def run_vqs_bf_trace(streams: SchedStreams, *, J: int, L: int, K: int,
                     Qcap: int, A_max: int, engine: str = "scan",
                     work_steps: int | None = None,
                     window: int | None = None,
                     max_requeue: int = DEFAULT_MAX_REQUEUE,
                     strict: bool = False) -> PolicyResult:
    """Run VQS-BF over explicit streams (random or trace-built; one
    cluster, or an ensemble with a leading G axis) on the streams'
    device."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    if engine == "cuda":
        if _cuda_ok(streams, J, L, K, Qcap, A_max, strict):
            from ...kernels.vqs_bf.ops import vqs_bf_simulate
            single = streams.n.ndim == 1
            res = vqs_bf_simulate(_batched(streams) if single else streams,
                                  J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                                  work_steps=work_steps, window=window)
            return _first(res) if single else res
        engine = "scan"
    if engine == "scan":
        return run_vqs_bf_streams(streams, J=J, L=L, K=K, Qcap=Qcap,
                                  A_max=A_max, work_steps=work_steps,
                                  max_requeue=max_requeue)
    raise ValueError(f"unknown engine {engine!r}; expected one of "
                     f"{', '.join(ENGINES)}")


def run_vqs_bf(seed: int, lam: float, mu: float, sampler: Callable,
               J: int = 4, L: int = 8, K: int = 16, Qcap: int = 512,
               A_max: int = 8, horizon: int = 10_000, engine: str = "scan",
               work_steps: int | None = None, window: int | None = None,
               fault_rate: float = 0.0, repair_rate: float = 1.0,
               max_requeue: int = DEFAULT_MAX_REQUEUE, strict: bool = False,
               device=None) -> PolicyResult:
    """Simulate VQS-BF on L unit-capacity servers for ``horizon`` slots.
    The streams (and any fault plane) are those a VQS run on the same seed
    draws, so the two policies compare on the same jobs."""
    if engine == "reference":
        raise NotImplementedError(_REFERENCE_TODO)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    streams = make_streams(gen, lam, mu, sampler, L=L, K=K, A_max=A_max,
                           horizon=horizon, device=device,
                           fault_rate=fault_rate, repair_rate=repair_rate)
    return run_vqs_bf_trace(streams, J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                            engine=engine, work_steps=work_steps,
                            window=window, max_requeue=max_requeue,
                            strict=strict)


def monte_carlo_vqs_bf(seeds, lam: float, mu: float, sampler: Callable,
                       engine: str = "scan", work_steps: int | None = None,
                       window: int | None = None, J: int = 4, L: int = 8,
                       K: int = 16, Qcap: int = 512, A_max: int = 8,
                       horizon: int = 10_000, fault_rate: float = 0.0,
                       repair_rate: float = 1.0,
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
    return run_vqs_bf_trace(streams, J=J, L=L, K=K, Qcap=Qcap, A_max=A_max,
                            engine=engine, work_steps=work_steps,
                            window=window, max_requeue=max_requeue,
                            strict=strict)


def run_vqs_bf_workload(workload, seed: int = 0, *, engine: str = "scan",
                        **config) -> PolicyResult:
    """Workload-first adapter: the registry entry behind
    ``run_policy(workload, policy="vqs-bf", ...)``."""
    workload.require_scalar("vqs-bf")
    workload.check_sampler()
    return run_vqs_bf(seed, workload.lam, workload.mu, workload.sampler,
                      engine=engine, **config)


def monte_carlo_vqs_bf_workload(workload, seeds, *, engine: str = "scan",
                                **config) -> PolicyResult:
    """Workload-first adapter for ``monte_carlo_policy(policy="vqs-bf")``."""
    workload.require_scalar("vqs-bf")
    workload.check_sampler()
    return monte_carlo_vqs_bf(seeds, workload.lam, workload.mu,
                              workload.sampler, engine=engine, **config)
