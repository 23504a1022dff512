"""Queue structures for the event-driven engine.

``SortedJobQueue``  — exact multiset of queued jobs keyed by grid size, with
O(log RES) largest-fitting-job queries (Best-Fit server perspective) and
FIFO order inside each size bucket.

``VirtualQueues``   — the paper's VQs under partition I: per-type FIFO order
(VQS schedules head-of-line) AND per-type sorted access (VQS-BF schedules
largest-fitting), plus the global sorted view BF-S needs in VQS-BF step (iii).

Jobs are identified by integer ids; sizes are grid ints (quantize.RES).

Copied from ``repro.core.queues``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .fenwick import Fenwick
from .partition import PartitionI
from .quantize import RES


@dataclass(slots=True)
class Job:
    jid: int
    size: int        # actual grid size (occupies this much)
    eff_size: int    # occupancy size (== size except last-VQ round-up)
    vq: int          # virtual-queue index under partition I (or -1)
    arrival: int     # arrival slot
    dur: int = 0     # fixed service duration (0 => draw from ServiceModel)


class SortedJobQueue:
    """Multiset of jobs ordered by effective size; FIFO within equal sizes."""

    def __init__(self):
        self._fen = Fenwick(RES + 1)
        self._buckets: dict[int, deque[Job]] = {}
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def push(self, job: Job) -> None:
        b = self._buckets.get(job.eff_size)
        if b is None:
            b = deque()
            self._buckets[job.eff_size] = b
        b.append(job)
        self._fen.add(job.eff_size, 1)
        self._count += 1

    def pop_largest_leq(self, cap: int) -> Job | None:
        """Remove and return the largest job with eff_size <= cap (FIFO among
        equals). None if nothing fits."""
        key = self._fen.max_leq(min(cap, RES))
        if key < 0:
            return None
        b = self._buckets[key]
        job = b.popleft()
        if not b:
            del self._buckets[key]
        self._fen.add(key, -1)
        self._count -= 1
        return job

    def peek_largest_leq(self, cap: int) -> int:
        """Largest eff_size <= cap present, or -1."""
        return self._fen.max_leq(min(cap, RES))

    def remove(self, job: Job) -> bool:
        """Remove a specific job (linear in its bucket — buckets are small)."""
        b = self._buckets.get(job.eff_size)
        if not b:
            return False
        try:
            b.remove(job)
        except ValueError:
            return False
        if not b:
            del self._buckets[job.eff_size]
        self._fen.add(job.eff_size, -1)
        self._count -= 1
        return True

    def total_size(self) -> int:
        # O(buckets); used by diagnostics only.
        return sum(k * len(v) for k, v in self._buckets.items())


class FIFOJobQueue:
    """Plain FIFO queue (the FIFO-FF baseline)."""

    def __init__(self):
        self._q: deque[Job] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, job: Job) -> None:
        self._q.append(job)

    def head(self) -> Job | None:
        return self._q[0] if self._q else None

    def pop(self) -> Job:
        return self._q.popleft()


class VirtualQueues:
    """The 2J virtual queues of partition I.

    Each VQ keeps (a) FIFO order with lazy deletion (for VQS head-of-line
    scheduling) and (b) a sorted multiset (for VQS-BF largest-fit
    scheduling and the global BF-S sweep).
    """

    def __init__(self, J: int):
        self.part = PartitionI(J)
        self.J = J
        n = 2 * J
        self._fifo: list[deque[Job]] = [deque() for _ in range(n)]
        self._sorted: list[SortedJobQueue] = [SortedJobQueue() for _ in range(n)]
        self._removed: set[int] = set()
        self.sizes = np.zeros(n, dtype=np.int64)  # |VQ_j| vector Q

    def __len__(self) -> int:
        return int(self.sizes.sum())

    def classify(self, size_int: int) -> tuple[int, int]:
        vq = self.part.type_of_scalar(size_int)
        eff = max(size_int, self.part.min_grid_size) if vq == 2 * self.J - 1 else size_int
        return vq, eff

    def push(self, job: Job) -> None:
        self._fifo[job.vq].append(job)
        self._sorted[job.vq].push(job)
        self.sizes[job.vq] += 1

    def head(self, vq: int) -> Job | None:
        q = self._fifo[vq]
        while q and q[0].jid in self._removed:
            self._removed.discard(q[0].jid)
            q.popleft()
        return q[0] if q else None

    def pop_head(self, vq: int) -> Job | None:
        job = self.head(vq)
        if job is None:
            return None
        self._fifo[vq].popleft()
        self._sorted[vq].remove(job)
        self.sizes[vq] -= 1
        return job

    def pop_largest_leq(self, vq: int, cap: int) -> Job | None:
        job = self._sorted[vq].pop_largest_leq(cap)
        if job is None:
            return None
        self._removed.add(job.jid)  # lazy-delete from FIFO view
        self.sizes[vq] -= 1
        return job

    def remove_specific(self, job: Job) -> bool:
        """Remove a particular queued job (used by the arrival-side BF-J pass
        of VQS-BF)."""
        if self._sorted[job.vq].remove(job):
            self._removed.add(job.jid)
            self.sizes[job.vq] -= 1
            return True
        return False

    def pop_largest_leq_any(self, cap: int) -> Job | None:
        """Largest fitting job across ALL VQs (BF-S sweep in VQS-BF)."""
        best_vq, best_key = -1, -1
        for j in range(2 * self.J):
            if self.sizes[j] == 0:
                continue
            k = self._sorted[j].peek_largest_leq(cap)
            if k > best_key:
                best_key, best_vq = k, j
        if best_vq < 0:
            return None
        return self.pop_largest_leq(best_vq, cap)
