"""Best-Fit based schedulers (paper Section IV).

``BFJS``  — BF-J/S, the paper's main Best-Fit algorithm (Theorem 2: >= 1/2 rho*):
   step 1: BF-S over servers that had departures last slot (fill each with the
           largest queued job that fits, repeatedly);
   step 2: BF-J over newly arrived jobs not scheduled in step 1 (each goes to
           the tightest feasible server, else queues).

``BFJ`` / ``BFS`` — the standalone adaptations (Section IV.A), kept for
ablations; they rescan the whole queue / all servers each slot, so they are
O(Q)/O(L) per slot and intended for small experiments.

Copied from ``repro.core.best_fit``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from collections import deque

from .base import Scheduler
from .queues import Job, SortedJobQueue


class BFJS(Scheduler):
    """BF-J/S; with ``stall=True`` adds the Section-VIII stalling technique
    for general (non-geometric) service times: a server operating in an
    inefficient configuration (less than half full with nothing queued that
    restores efficiency) stops accepting jobs until it drains empty, which
    re-creates the renewal epochs the geometric analysis relies on."""

    name = "bf-js"

    def __init__(self, stall: bool = False):
        self.stall = stall
        if stall:
            self.name = "bf-js-stall"

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        self.queue = SortedJobQueue()
        self._new: list[Job] = []
        self._stalled: set[int] = set()
        return self

    def on_arrivals(self, t, jobs):
        for job in jobs:
            self.queue.push(job)
        self._new = jobs

    def _maybe_stall(self, server: int) -> None:
        """Stall when the server is inefficient (< half full) and the queue
        cannot top it up past half."""
        cl = self.cluster
        cap = int(cl.capacity[server])
        occ = cl.occupancy(server)
        if 0 < occ < cap // 2 and \
                self.queue.peek_largest_leq(int(cl.residual[server])) < 0:
            self._stalled.add(server)

    def schedule(self, t, freed, emptied):
        cl = self.cluster
        if self.stall:
            self._stalled -= emptied          # drained: back in service
        # Step 1: BF-S over servers freed by departures during this slot.
        for server in sorted(freed):
            if server in self._stalled:
                continue
            while True:
                job = self.queue.pop_largest_leq(int(cl.residual[server]))
                if job is None:
                    break
                self._place(t, server, job)
            if self.stall:
                self._maybe_stall(server)
        # Step 2: BF-J over the new arrivals that step 1 did not place.
        for job in self._new:
            server = self._tightest_unstalled(job.eff_size)
            if server >= 0 and self.queue.remove(job):
                self._place(t, server, job)
        self._new = []

    def _tightest_unstalled(self, size: int) -> int:
        cl = self.cluster
        if not self._stalled:
            return cl.tightest_feasible(size)
        best, best_r = -1, None
        for server in range(cl.L):
            if server in self._stalled:
                continue
            r = int(cl.residual[server])
            if r >= size and (best_r is None or r < best_r):
                best, best_r = server, r
        return best

    def queue_len(self):
        return len(self.queue)

    def queued_total_size(self):
        return self.queue.total_size()


class BFJ(Scheduler):
    """Best-Fit from the job's perspective, full rescan each slot."""

    name = "bf-j"

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        self.queue: deque[Job] = deque()
        return self

    def on_arrivals(self, t, jobs):
        self.queue.extend(jobs)

    def schedule(self, t, freed, emptied):
        cl = self.cluster
        remaining: deque[Job] = deque()
        while self.queue:
            job = self.queue.popleft()
            server = cl.tightest_feasible(job.eff_size)
            if server >= 0:
                self._place(t, server, job)
            else:
                remaining.append(job)
        self.queue = remaining

    def queue_len(self):
        return len(self.queue)


class BFS(Scheduler):
    """Best-Fit from the server's perspective, full rescan each slot."""

    name = "bf-s"

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        self.queue = SortedJobQueue()
        return self

    def on_arrivals(self, t, jobs):
        for job in jobs:
            self.queue.push(job)

    def schedule(self, t, freed, emptied):
        cl = self.cluster
        for server in range(cl.L):
            while True:
                job = self.queue.pop_largest_leq(int(cl.residual[server]))
                if job is None:
                    break
                self._place(t, server, job)

    def queue_len(self):
        return len(self.queue)

    def queued_total_size(self):
        return self.queue.total_size()
