"""Plain PyTorch version of the live admission kernel: the same five ops
on CPU tensors, in place, step for step as the JAX package's
``serving/live.py`` (``torch.argmin`` / ``argmax`` return the first extreme,
``torch.roll`` shifts the queue lanes).  Scalars are Python ints that wrap
as int32 does.

``state`` is any NamedTuple with the fields ``residual``, ``q_rid``,
``q_size``, ``q_len``, ``dropped`` and ``invalid``; ``ev`` is a ``(3, A)``
int32 tensor of event lanes; ``out`` receives ``[count, q_len, dropped,
invalid]`` then the op's lanes, as the kernel writes them."""
from __future__ import annotations

import torch

from ...core.quantize import RES

HEADER = 4
_I32_MAX = 2 ** 31 - 1


def _wrap(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


class _Run:
    """One op on ``state``: the counters as Python ints, written back (and
    into the header of ``out``) by :meth:`finish`."""

    def __init__(self, state, out):
        self.st, self.out = state, out
        self.q_len = int(state.q_len)
        self.dropped = int(state.dropped)
        self.invalid = int(state.invalid)
        self.count = 0

    def finish(self) -> None:
        self.st.q_len.fill_(self.q_len)
        self.st.dropped.fill_(self.dropped)
        self.st.invalid.fill_(self.invalid)
        self.out[:HEADER] = torch.tensor(
            [self.count, self.q_len, self.dropped, self.invalid],
            dtype=torch.int32)

    def push_back(self, rid: int, size: int) -> None:
        Qcap = self.st.q_rid.shape[0]
        if self.q_len < Qcap:
            self.st.q_rid[self.q_len] = rid
            self.st.q_size[self.q_len] = size
            self.q_len += 1
        else:
            self.dropped += 1

    def refill(self, replica: int) -> None:
        """BF-S on one replica: the first largest fitting lane, until none
        fits; lanes after it shift left (a roll, as ``jnp.roll``)."""
        st, Qcap = self.st, self.st.q_rid.shape[0]
        lanes = torch.arange(Qcap)
        while True:
            fits = (lanes < self.q_len) & (st.q_size <= st.residual[replica])
            if not bool(fits.any()):
                return
            pick = int(torch.argmax(torch.where(fits, st.q_size, -1)))
            size, rid = int(st.q_size[pick]), int(st.q_rid[pick])
            st.residual[replica] = _wrap(int(st.residual[replica]) - size)
            st.q_rid[pick:] = torch.roll(st.q_rid, -1)[pick:]
            st.q_size[pick:] = torch.roll(st.q_size, -1)[pick:]
            self.q_len -= 1
            if self.count < Qcap:
                self.out[HEADER + self.count] = rid
                self.out[HEADER + Qcap + self.count] = replica
            self.count += 1

    def release(self, ev: torch.Tensor, freed=None) -> None:
        res, L = self.st.residual, self.st.residual.shape[0]
        for rep, size, live in ev.t().tolist():
            known = 0 <= rep < L
            at = min(max(rep, 0), L - 1)
            ok = bool(live) and known and size >= 0 \
                and _wrap(int(res[at]) + size) <= RES
            if ok:
                res[at] = _wrap(int(res[at]) + size)
            self.invalid += int(bool(live) and not ok)
            if freed is not None and live and known:
                freed[rep] = True


def admit_ref(state, ev: torch.Tensor, out: torch.Tensor) -> None:
    """BF-J over the live lanes of ``ev`` (rid, size, live), in order: the
    first least feasible residual, else the queue tail (or a drop);
    ``out[HEADER + j]`` is lane j's replica, -1 when not placed."""
    run, res = _Run(state, out), state.residual
    out[HEADER:] = -1
    for j, (rid, size, live) in enumerate(ev.t().tolist()):
        if not live:
            continue
        feas = res >= size
        if bool(feas.any()):
            best = int(torch.argmin(torch.where(feas, res, _I32_MAX)))
            res[best] = _wrap(int(res[best]) - size)
            out[HEADER + j] = best
        else:
            run.push_back(rid, size)
    run.finish()


def refill_ref(state, replica: int, out: torch.Tensor) -> None:
    """BF-S refill of one replica; placements in ``out``."""
    run = _Run(state, out)
    out[HEADER:] = -1
    run.refill(int(replica))
    run.finish()


def release_ref(state, ev: torch.Tensor, out: torch.Tensor) -> None:
    """Release each live (replica, size) event; invalid ones are counted."""
    run = _Run(state, out)
    run.release(ev)
    run.finish()


def tick_ref(state, ev: torch.Tensor, out: torch.Tensor) -> None:
    """All releases, then BF-S on each replica an event named, ascending."""
    run = _Run(state, out)
    out[HEADER:] = -1
    freed = torch.zeros(state.residual.shape[0], dtype=torch.bool)
    run.release(ev, freed)
    for r in torch.nonzero(freed).flatten().tolist():
        run.refill(r)
    run.finish()


def push_front_ref(state, rid: int, size: int, out: torch.Tensor) -> None:
    """Insert at the queue head; a full queue drops (and counts) its
    tail."""
    run, Qcap = _Run(state, out), state.q_rid.shape[0]
    run.dropped += int(run.q_len >= Qcap)
    state.q_rid.copy_(torch.roll(state.q_rid, 1))
    state.q_size.copy_(torch.roll(state.q_size, 1))
    state.q_rid[0], state.q_size[0] = rid, size
    run.q_len = min(run.q_len + 1, Qcap)
    run.finish()
