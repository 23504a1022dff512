"""Device-resident live admission: BF-J/S bookkeeping as one launch a call
(the port of ``repro.serving.live``).

``cluster/admission.py`` runs the paper's BF-J/S admission as host Python —
an argmin per admitted request and a scan of the whole queue per BF-S
refill step, every engine tick.  This module keeps the ENTIRE admission
state on the card:

    LiveAdmissionState.residual  (L,)    int32 grid-unit residuals
                      .q_rid     (Qcap,) int32 FIFO queue, lane 0 = head
                      .q_size    (Qcap,) int32 (compacted: live lanes first)
                      .q_len, .dropped, .invalid  () int32 counters

and runs each controller call — admit, refill, release, a whole tick's
releases and refills, push_front — as ONE launch of a hand-written kernel
(``kernels/live_admission``; on CPU tensors, its plain version).  The host
copies back only the small placement vector and the counters of the call.

Semantics are EXACTLY ``AdmissionController``'s and the JAX module's, lane
for lane:

  * BF-J: the first least feasible residual (ties to the lowest replica);
  * BF-S: the largest fitting job first, the earliest queued among equals;
  * ``release`` guards the capacity invariant: where the host controller
    raises, the kernel counts the violation in ``invalid`` and the facade
    raises :class:`~repro_torch.core.engine.supervisor.InvariantViolation`
    on its next read.

Queue overflow is counted in ``dropped``: size ``Qcap`` so that parity
holds whenever the host queue stays within it.

The step functions update ``state`` in place (one kernel, no copy) and
return it, in the JAX module's return shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.engine.supervisor import InvariantViolation
from ..core.quantize import RES
from ..device import resolve_device
from ..kernels.live_admission import ops
from ..kernels.live_admission.live_admission import HEADER


class LiveAdmissionState(NamedTuple):
    """Complete device-resident admission state (see module docstring)."""
    residual: torch.Tensor   # (L,) int32 free grid units per replica
    q_rid: torch.Tensor      # (Qcap,) int32 queued request ids
    q_size: torch.Tensor     # (Qcap,) int32 queued sizes (grid units)
    q_len: torch.Tensor      # () int32 live queue lanes
    dropped: torch.Tensor    # () int32 arrivals dropped on queue overflow
    invalid: torch.Tensor    # () int32 release-invariant violations


def init_state(num_replicas: int, Qcap: int,
               device=None) -> LiveAdmissionState:
    """Empty queue, every replica free, on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    counters = torch.zeros(3, dtype=torch.int32, device=device)
    return LiveAdmissionState(
        residual=torch.full((num_replicas,), RES, dtype=torch.int32,
                            device=device),
        q_rid=torch.full((Qcap,), -1, dtype=torch.int32, device=device),
        q_size=torch.zeros((Qcap,), dtype=torch.int32, device=device),
        q_len=counters[0], dropped=counters[1], invalid=counters[2])


def _lanes(state: LiveAdmissionState, a, b, mask) -> torch.Tensor:
    """The ``(3, A)`` int32 event lanes of the kernel, on the state's
    device (one host-to-device copy for host arrays)."""
    rows = [torch.as_tensor(x).reshape(-1).to(torch.int32).cpu()
            for x in (a, b, mask)]
    return torch.stack(rows).to(state.residual.device)


def _placements(state, out):
    Qcap = state.q_rid.shape[0]
    return (out[HEADER:HEADER + Qcap], out[HEADER + Qcap:], out[0])


def admit_step(state: LiveAdmissionState, rids, sizes, mask):
    """BF-J over one tick's arrivals: ``(A,)`` lanes in order.  Returns the
    state and ``(A,)`` placements (replica, or -1 = queued/dropped)."""
    out = ops.admit(state, _lanes(state, rids, sizes, mask))
    return state, out[HEADER:]


def refill_step(state: LiveAdmissionState, replica):
    """BF-S refill of one replica.  Returns the state and the placement
    buffers ``(rids, replicas, count)``: lanes ``[0, count)`` are the
    placements, in placement order."""
    out = ops.refill(state, int(replica))
    return state, _placements(state, out)


def release_step(state: LiveAdmissionState, replicas, sizes,
                 mask) -> LiveAdmissionState:
    """Release a batch of completions (no refill)."""
    ops.release(state, _lanes(state, replicas, sizes, mask))
    return state


def tick_step(state: LiveAdmissionState, replicas, sizes, mask):
    """One engine tick: release every completion, then BF-S-refill each
    replica that freed memory, in ascending replica order — the host
    engine's per-replica release + refill sequence (a refill reads only its
    own replica's residual, so releasing first is order-equivalent).
    Returns the state and the placement buffers of all the tick's
    refills."""
    out = ops.tick(state, _lanes(state, replicas, sizes, mask))
    return state, _placements(state, out)


def push_front_step(state: LiveAdmissionState, rid,
                    size) -> LiveAdmissionState:
    """Queue-head insert (the engine's slot-rejection path).  On a full
    queue the TAIL job is dropped and counted."""
    ops.push_front(state, int(rid), int(size))
    return state


class LiveAdmission:
    """Host facade over the one-launch admission ops — drop-in for
    ``AdmissionController`` in ``ServingEngine`` (``admission="live"``).

    State lives on ``device`` (default: the card) between calls; each
    method that changes it is one kernel launch (``calls`` counts them),
    and only placement vectors and the counters come back to the host.
    ``tick(events)`` is the per-engine-tick fast path: release + all
    refills in one launch."""

    def __init__(self, num_replicas: int, Qcap: int = 512,
                 tick_width: int | None = None, device=None):
        self.num_replicas = num_replicas
        self.Qcap = Qcap
        #: fixed completion-event lane count per tick (pad + mask)
        self.tick_width = tick_width
        self.state = init_state(num_replicas, Qcap, device)
        self.calls = 0
        #: the last op's out buffer on the card, and its header on the host
        #: once read ([count, q_len, dropped, invalid])
        self._out = None
        self._host = [0, 0, 0, 0]

    # -- bookkeeping --------------------------------------------------------
    def _launched(self, out: torch.Tensor, read: bool) -> np.ndarray | None:
        self.calls += 1
        self._out = out
        if not read:
            self._host = None
            return None
        host = out.cpu().numpy()
        self._host = host[:HEADER].tolist()
        return host

    def _header(self) -> list[int]:
        if self._host is None:
            self._host = self._out[:HEADER].tolist()
        return self._host

    def _check(self) -> None:
        inv = self._header()[3]
        if inv:
            raise InvariantViolation(
                f"{inv} invalid release(s) since the last sync — double "
                "release, unknown replica, or size mismatch (the host "
                "controller raises eagerly; the device op counts and raises "
                "on sync)", invariant="occupancy_capacity")

    def queue_len(self) -> int:
        self._check()
        return self._header()[1]

    @property
    def residual(self) -> np.ndarray:
        return self.state.residual.cpu().numpy()

    @property
    def dropped(self) -> int:
        return self._header()[2]

    # -- the AdmissionController surface ------------------------------------
    def admit(self, jobs) -> list[tuple[int, int]]:
        """BF-J over new requests; returns [(rid, replica)] placements."""
        if not jobs:
            return []
        rids = np.asarray([j.rid for j in jobs], np.int32)
        ev = np.stack([rids, np.asarray([j.size for j in jobs], np.int32),
                       np.ones(len(jobs), np.int32)])
        out = self._launched(ops.admit(self.state, self._to_device(ev)),
                             read=True)
        placed = out[HEADER:]
        return [(int(rids[i]), int(placed[i]))
                for i in range(len(jobs)) if placed[i] >= 0]

    def refill(self, replica: int) -> list[tuple[int, int]]:
        """BF-S over the device queue after a release on ``replica``."""
        out = self._launched(ops.refill(self.state, replica), read=True)
        return self._placed(out)

    def release(self, replica: int, size: int) -> None:
        """Return grid units to ``replica`` — stays on the card; invariant
        violations are counted and raised on the next read."""
        ev = np.asarray([[replica], [size], [1]], np.int32)
        self._launched(ops.release(self.state, self._to_device(ev)),
                       read=False)

    def push_front(self, job) -> None:
        """Queue-head insert (slot-rejection re-admission path)."""
        self._launched(ops.push_front(self.state, job.rid, job.size),
                       read=False)

    # -- the fused fast path ------------------------------------------------
    def tick(self, events: list[tuple[int, int]]) -> list[tuple[int, int]]:
        """One engine tick: ``events`` is [(replica, size)] completions.
        Releases all of them and BF-S-refills every freed replica in one
        launch; returns [(rid, replica)] placements in the host engine's
        order.  Pads to ``tick_width`` lanes."""
        width = self.tick_width or max(len(events), 1)
        if len(events) > width:
            raise ValueError(
                f"{len(events)} completion events exceed tick_width="
                f"{width}; raise tick_width (it bounds one tick's lanes)")
        ev = np.zeros((3, width), np.int32)
        ev[0] = -1
        for i, (r, s) in enumerate(events):
            ev[:, i] = (r, s, 1)
        out = self._launched(ops.tick(self.state, self._to_device(ev)),
                             read=True)
        placed = self._placed(out)
        self._check()
        return placed

    def _to_device(self, ev: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(ev).to(self.state.residual.device)

    def _placed(self, out: np.ndarray) -> list[tuple[int, int]]:
        n = int(out[0])
        rids = out[HEADER:HEADER + n]
        reps = out[HEADER + self.Qcap:HEADER + self.Qcap + n]
        return [(int(rids[i]), int(reps[i])) for i in range(n)]
