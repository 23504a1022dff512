"""Cluster state for the event-driven engine: servers, placements, departures.

Design notes (performance):
  * Service durations are drawn at placement time (geometric sampling at
    placement is distributionally identical to per-slot memoryless coin
    flips) and placed into per-slot departure buckets => total departure
    processing is O(#jobs) over the whole run, never O(#in-service) per slot.
  * Best-Fit "tightest feasible server" queries use a Fenwick tree over the
    residual-capacity histogram + residual->server-id sets => O(log RES).
  * First-Fit "lowest-index feasible server" uses a max segment tree over
    server indices => O(log L).
Heterogeneous capacities are supported (capacity array in grid units).

Copied from ``repro.core.cluster_state``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .fenwick import Fenwick, SegTreeMax
from .queues import Job
from .quantize import RES


class Cluster:
    def __init__(self, L: int, capacities: np.ndarray | None = None):
        self.L = L
        if capacities is None:
            capacities = np.full(L, RES, dtype=np.int64)
        self.capacity = np.asarray(capacities, dtype=np.int64)
        self.residual = self.capacity.copy()
        self.jobs: list[dict[int, Job]] = [dict() for _ in range(L)]
        # residual histogram structures for Best-Fit
        self._fen = Fenwick(RES + 1)
        self._by_resid: dict[int, set[int]] = {}
        for s in range(L):
            self._resid_add(s, int(self.residual[s]))
        # first-fit segment tree
        self._seg = SegTreeMax(self.residual)
        # departures: slot -> list[(server, jid)]
        self._dep_buckets: dict[int, list[tuple[int, int]]] = {}
        # cancelled pending departures (job evicted/re-placed): multiset
        self._cancelled: dict[tuple[int, int], int] = {}
        self.freed_last_slot: set[int] = set()
        self.emptied_last_slot: set[int] = set()
        self.departed_jobs = 0
        self.departed_size = 0
        self.busy_area = 0  # sum over slots of total occupied size (utilization)

    # -- residual index maintenance -------------------------------------
    def _resid_add(self, server: int, r: int) -> None:
        s = self._by_resid.get(r)
        if s is None:
            s = set()
            self._by_resid[r] = s
        if not s:
            self._fen.add(r, 1)
        s.add(server)

    def _resid_remove(self, server: int, r: int) -> None:
        s = self._by_resid[r]
        s.discard(server)
        if not s:
            self._fen.add(r, -1)

    def _set_residual(self, server: int, new_r: int) -> None:
        old = int(self.residual[server])
        if new_r == old:
            return
        self._resid_remove(server, old)
        self.residual[server] = new_r
        self._resid_add(server, new_r)
        self._seg.update(server, new_r)

    # -- queries ----------------------------------------------------------
    def tightest_feasible(self, size: int) -> int:
        """Best-Fit: server with the LEAST residual >= size; -1 if none."""
        r = self._fen.min_geq(size)
        if r < 0:
            return -1
        # deterministic tie-break: smallest id in the bucket
        return min(self._by_resid[r])

    def first_fit(self, size: int) -> int:
        """First-Fit: smallest-index server with residual >= size; -1 if none."""
        return self._seg.first_fit(size)

    def occupancy(self, server: int) -> int:
        return int(self.capacity[server] - self.residual[server])

    def num_jobs(self, server: int) -> int:
        return len(self.jobs[server])

    def total_occupied(self) -> int:
        return int((self.capacity - self.residual).sum())

    # -- placement / departures -------------------------------------------
    def place(self, server: int, job: Job, depart_slot: int) -> None:
        r = int(self.residual[server]) - job.eff_size
        if r < 0:
            raise RuntimeError(
                f"capacity violation: server {server} resid {self.residual[server]} "
                f"< job {job.eff_size}"
            )
        self.jobs[server][job.jid] = job
        self._set_residual(server, r)
        self._dep_buckets.setdefault(depart_slot, []).append((server, job.jid))

    def process_departures(self, t: int) -> tuple[set[int], set[int]]:
        """Apply all departures scheduled for slot t.

        Returns (freed_servers, emptied_servers): servers with >=1 departure,
        and the subset that became empty during this slot (the paper's
        configuration-renewal epochs tau_i^l).
        """
        freed: set[int] = set()
        emptied: set[int] = set()
        bucket = self._dep_buckets.pop(t, None)
        if bucket:
            for server, jid in bucket:
                key = (server, jid)
                n = self._cancelled.get(key, 0)
                if n:  # evicted / re-placed job: skip this stale entry
                    if n == 1:
                        del self._cancelled[key]
                    else:
                        self._cancelled[key] = n - 1
                    continue
                job = self.jobs[server].pop(jid)
                self._set_residual(server, int(self.residual[server]) + job.eff_size)
                freed.add(server)
                self.departed_jobs += 1
                self.departed_size += job.eff_size
            for server in freed:
                if not self.jobs[server]:
                    emptied.add(server)
        self.freed_last_slot = freed
        self.emptied_last_slot = emptied
        return freed, emptied

    def evict(self, server: int, jid: int) -> Job:
        """Remove a job before its departure (failure / preemption); the
        pending departure entry is cancelled."""
        job = self.jobs[server].pop(jid)
        self._set_residual(server, int(self.residual[server]) + job.eff_size)
        self._cancelled[(server, jid)] = \
            self._cancelled.get((server, jid), 0) + 1
        return job

    def accumulate_utilization(self) -> None:
        self.busy_area += self.total_occupied()

    def check_invariants(self) -> None:
        """Raise on bookkeeping corruption (an ``assert`` would vanish
        under ``python -O``).  Raises
        :class:`~repro_torch.core.engine.supervisor.InvariantViolation` — a
        ``ValueError`` subclass — naming the failed counter and servers."""
        from .engine.supervisor import InvariantViolation
        occ = np.zeros(self.L, dtype=np.int64)
        for s in range(self.L):
            occ[s] = sum(j.eff_size for j in self.jobs[s].values())
        if not np.all(occ + self.residual == self.capacity):
            bad = np.flatnonzero(occ + self.residual != self.capacity)
            raise InvariantViolation(
                f"residual mismatch on server(s) {bad.tolist()}: "
                f"occupied {occ[bad].tolist()} + residual "
                f"{self.residual[bad].tolist()} != capacity "
                f"{np.broadcast_to(self.capacity, occ.shape)[bad].tolist()}",
                invariant="occupancy_capacity")
        if not np.all(self.residual >= 0):
            bad = np.flatnonzero(self.residual < 0)
            raise InvariantViolation(
                f"negative residual on server(s) {bad.tolist()}: "
                f"{self.residual[bad].tolist()}",
                invariant="queue_nonneg")


class ServiceModel:
    """Draws service durations (in slots) at placement time."""

    def __init__(self, kind: str = "geometric", mean: float = 100.0):
        if kind not in ("geometric", "fixed"):
            raise ValueError(kind)
        self.kind = kind
        self.mean = float(mean)
        self.mu = 1.0 / self.mean

    def draw(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        if self.kind == "geometric":
            return rng.geometric(self.mu, size=n)
        return np.full(n, int(round(self.mean)), dtype=np.int64)


ArrivalProcess = Callable[[np.random.Generator], int]


def poisson_arrivals(lam: float) -> ArrivalProcess:
    def f(rng: np.random.Generator) -> int:
        return int(rng.poisson(lam))

    return f
