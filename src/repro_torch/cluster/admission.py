"""Admission control = the paper's scheduling problem, verbatim (a copy of
``repro.cluster.admission``; host numpy, no device work).

A serving fleet of L replicas is the paper's cluster of L unit-capacity
servers; an inference request with (prompt + budgeted generation) tokens
occupies a FRACTION of a replica's KV-cache memory — a job with random
resource requirement R in (0, 1] drawn from an unknown distribution (users
decide prompt lengths).  Service time = generation length (geometric-ish).
The controller therefore runs BF-J/S (Theorem 2) or VQS-BF (Theorem 4)
UNCHANGED on the replica residuals.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.partition import PartitionI, k_red
from repro_torch.core.quantize import RES, to_grid


@dataclass
class PendingJob:
    rid: int
    frac: float              # KV fraction of one replica (paper's R_j)
    size: int = 0            # grid units

    def __post_init__(self):
        self.size = int(to_grid([self.frac])[0])


ADMISSION_POLICIES = ("bf", "vqs-bf", "fifo")


@dataclass
class AdmissionController:
    """Queueing-policy admission over replica residual capacity.

    Replicas' residuals are tracked in paper grid units; ``admit`` is the
    arrival pass over new requests and ``refill(replica)`` the queue-serve
    pass run when a replica frees memory (request completes).  The
    ``policy`` field selects the queue discipline:

    ``"bf"``
        BF-J/S (Theorem 2): ``admit`` best-fits each new request,
        ``refill`` serves the queue largest-fitting-first.
    ``"vqs-bf"``
        VQS-BF (Theorem 4): ``refill`` renews the replica's configuration
        via :meth:`max_weight_config` (paper Eq. 8) at empty epochs, then
        serves (i) one largest fitting VQ_1 request when the configuration
        asks for one and none is resident, (ii) the other configured type
        largest-fit-first up to its k_{j*} cap, (iii) a BF-S sweep over
        the whole queue; ``admit`` is the same BF-J arrival pass
        (``VQSBF.schedule``'s closing step).
    ``"fifo"``
        Head-of-line: ``admit`` places only when nothing is waiting,
        ``refill`` serves the queue head while it fits (honest
        head-of-line blocking — the baseline the paper improves on).

    Unknown values raise ``ValueError`` at construction.
    """

    num_replicas: int
    policy: str = "bf"          # one of ADMISSION_POLICIES
    J: int = 6
    queue: list[PendingJob] = field(default_factory=list)
    residual: np.ndarray = None
    _vq_sizes: np.ndarray = None
    _active_cfg: list = None

    def __post_init__(self):
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {self.policy!r}; expected one "
                f"of {', '.join(ADMISSION_POLICIES)}")
        self.residual = np.full(self.num_replicas, RES, dtype=np.int64)
        self.part = PartitionI(self.J)
        self._kred = k_red(self.J)
        self._vq_sizes = np.zeros(2 * self.J, dtype=np.int64)
        self._active_cfg = [None] * self.num_replicas
        # per-replica resident request counts by partition type — the
        # vqs-bf serve pass needs "is a VQ_1 request resident" / "how many
        # of type j*"; maintained for every policy (release infers the
        # type from the released size, exact on the grid)
        self._resident = np.zeros((self.num_replicas, 2 * self.J),
                                  dtype=np.int64)

    # -- paper scheduling -------------------------------------------------
    def _best_fit_server(self, size: int) -> int:
        feas = self.residual >= size
        if not feas.any():
            return -1
        masked = np.where(feas, self.residual, np.iinfo(np.int64).max)
        return int(np.argmin(masked))

    def _place(self, job: PendingJob, replica: int,
               placed: list[tuple[int, int]]) -> None:
        self.residual[replica] -= job.size
        self._resident[replica][self.part.type_of_scalar(job.size)] += 1
        placed.append((job.rid, replica))

    def _enqueue(self, job: PendingJob) -> None:
        self.queue.append(job)
        self._vq_sizes[self.part.type_of_scalar(job.size)] += 1

    def _take(self, job: PendingJob, replica: int,
              placed: list[tuple[int, int]]) -> None:
        self.queue.remove(job)
        self._vq_sizes[self.part.type_of_scalar(job.size)] -= 1
        self._place(job, replica, placed)

    def _largest_fitting(self, replica: int, vq: int | None = None):
        """Largest queued request that fits ``replica``'s residual,
        optionally restricted to partition type ``vq``; FIFO among equal
        sizes (``max`` keeps the earliest queued maximal element)."""
        fits = [j for j in self.queue
                if j.size <= self.residual[replica]
                and (vq is None or self.part.type_of_scalar(j.size) == vq)]
        return max(fits, key=lambda j: j.size) if fits else None

    def admit(self, jobs: list[PendingJob]) -> list[tuple[int, int]]:
        """Arrival pass over new requests; returns [(rid, replica)]
        placements.  BF-J for ``bf`` and ``vqs-bf`` (the latter is
        ``VQSBF.schedule``'s closing arrival pass); ``fifo`` admits only
        past an empty queue (no overtaking)."""
        placed = []
        for job in jobs:
            if self.policy == "fifo" and self.queue:
                self._enqueue(job)
                continue
            r = self._best_fit_server(job.size)
            if r >= 0:
                self._place(job, r, placed)
            else:
                self._enqueue(job)
        return placed

    def refill(self, replica: int) -> list[tuple[int, int]]:
        """Serve the queue after memory was released on ``replica``:
        BF-S (``bf``), the configured (i)–(iii) VQS-BF order (``vqs-bf``)
        or head-of-line (``fifo``)."""
        placed = []
        if self.policy == "fifo":
            while self.queue and \
                    self.queue[0].size <= self.residual[replica]:
                self._take(self.queue[0], replica, placed)
            return placed
        if self.policy == "vqs-bf":
            # configuration renewal at empty epochs (paper Eq. 8)
            if self.residual[replica] == RES \
                    or self._active_cfg[replica] is None:
                self._active_cfg[replica] = self.max_weight_config()
            row = self._active_cfg[replica]
            k1 = row[1] > 0
            others = [j for j in np.flatnonzero(row) if j != 1]
            jstar = int(others[0]) if others else -1
            kstar = int(row[jstar]) if jstar >= 0 else 0
            # (i) one largest fitting VQ_1 request, if none resident
            if k1 and self._resident[replica][1] == 0:
                job = self._largest_fitting(replica, vq=1)
                if job is not None:
                    self._take(job, replica, placed)
            # (ii) largest-fit-first from VQ_{j*}, capped at k_{j*}
            while jstar >= 0 and self._resident[replica][jstar] < kstar:
                job = self._largest_fitting(replica, vq=jstar)
                if job is None:
                    break
                self._take(job, replica, placed)
            # (iii) BF-S sweep over the whole queue — falls through to bf
        while self.queue:
            job = self._largest_fitting(replica)  # largest fitting first
            if job is None:
                break
            self._take(job, replica, placed)
        return placed

    def release(self, replica: int, size: int) -> None:
        """Return ``size`` grid units to ``replica`` (request completed).

        Guards the controller's capacity invariant: freeing more than the
        replica ever lent out means double-release or a size-accounting
        bug upstream — raise instead of silently corrupting residuals
        (an ``assert`` would vanish under ``python -O``).
        """
        if not 0 <= replica < self.num_replicas:
            raise ValueError(
                f"release on unknown replica {replica} "
                f"(controller has {self.num_replicas})")
        if size < 0:
            raise ValueError(f"release of negative size {size} on "
                             f"replica {replica}")
        if self.residual[replica] + size > RES:
            raise ValueError(
                f"release of {size} grid units on replica {replica} "
                f"exceeds capacity: residual {int(self.residual[replica])} "
                f"+ {size} > {RES} — double release or size mismatch")
        self.residual[replica] += size
        if size > 0:
            vq = self.part.type_of_scalar(size)
            if self._resident[replica][vq] > 0:
                self._resident[replica][vq] -= 1

    def push_front(self, job: PendingJob) -> None:
        """Queue-head insert: the serving engine's slot-rejection path
        re-admits a memory-admitted request ahead of every waiting one
        (it outranks the newest arrival).  Keeps the virtual-queue
        accounting consistent — ``refill`` will decrement the same type
        counter when the job eventually places.

        The JAX package's device-resident controller
        (``repro.serving.live``) implements the identical operation as a
        jitted queue roll; the port has not ported it yet.
        """
        self.queue.insert(0, job)
        self._vq_sizes[self.part.type_of_scalar(job.size)] += 1

    def queue_len(self) -> int:
        return len(self.queue)

    def max_weight_config(self):
        """Paper Eq. (8) over the controller's virtual queues (VQS-BF mode
        renews replica configurations with this at empty epochs)."""
        w = self._kred @ self._vq_sizes
        return self._kred[int(np.argmax(w))]
