"""VQS — Virtual Queue Scheduling (paper Section V, Theorem 3: >= 2/3 rho*).

Every server holds an *active configuration* from the reduced set K_RED^(J)
(4J-4 configurations), renewed ONLY when the server is empty (the paper's
tau_i^l epochs, non-preemptive like [6],[9]) to the max-weight configuration
<k, Q> over the VQ-size vector Q.  Scheduling under an active configuration:

  (i)  if k_1 = 1 the server reserves 2/3 of its capacity for a single VQ_1
       job (type 1 = sizes in (1/2, 2/3]) and schedules one when missing;
  (ii) the (at most one) other type j* is served from the HEAD of VQ_{j*}
       until the head no longer fits in the unreserved capacity — actual
       (unrounded) sizes are used, so more than k_{j*} jobs may be packed.

The implementation is event-driven: a server is (re)visited only when it had
departures, became/stays empty while work is queued, or a VQ it is starving
on receives an arrival (subscription wake-ups) — O(events), not O(L) per slot.

Copied from ``repro.core.vqs``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import numpy as np

from .base import Scheduler
from .partition import PartitionI, k_red
from .queues import Job, VirtualQueues
from .quantize import RES, TWO_THIRDS


class VQS(Scheduler):
    name = "vqs"

    def __init__(self, J: int):
        self.J = J
        self.part = PartitionI(J)
        self._kred = k_red(J)

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        L = cluster.L
        self.vqs = VirtualQueues(self.J)
        # per-server active configuration, compact: (k1, jstar, kstar)
        self._k1 = np.zeros(L, dtype=bool)
        self._jstar = np.full(L, -1, dtype=np.int64)
        self._kstar = np.zeros(L, dtype=np.int64)
        self._has_cfg = np.zeros(L, dtype=bool)
        self._empty: set[int] = set(range(L))
        self._want: list[set[int]] = [set() for _ in range(2 * self.J)]
        return self

    # -- job classification -------------------------------------------------
    def make_job(self, jid, size_int, t, dur=0):
        vq, eff = self.vqs.classify(size_int) if hasattr(self, "vqs") else (-1, size_int)
        return Job(jid, size_int, eff, vq, t, dur)

    def on_arrivals(self, t, jobs):
        self._arrived_types: set[int] = set()
        for job in jobs:
            self.vqs.push(job)
            self._arrived_types.add(job.vq)

    # -- configuration management -------------------------------------------
    def _renew(self, server: int) -> None:
        w = self._kred @ self.vqs.sizes
        row = self._kred[int(np.argmax(w))]
        self._set_config(server, row)

    def _set_config(self, server: int, row: np.ndarray) -> None:
        k1 = row[1] > 0
        nz = np.nonzero(row)[0]
        other = [j for j in nz if j != 1]
        self._k1[server] = k1
        self._jstar[server] = other[0] if other else -1
        self._kstar[server] = row[other[0]] if other else 0
        self._has_cfg[server] = True

    # -- scheduling -----------------------------------------------------------
    def schedule(self, t, freed, emptied):
        woken: set[int] = set()
        for j in getattr(self, "_arrived_types", set()):
            woken |= self._want[j]
            self._want[j].clear()
        self._arrived_types = set()

        visit: set[int] = set(freed) | set(emptied) | woken
        if len(self.vqs) > 0 and self._empty:
            visit |= self._empty
        for server in sorted(visit):
            if self.cluster.num_jobs(server) == 0:
                self._renew(server)
                self._empty.add(server)
            self._serve(t, server)

    def _serve(self, t: int, server: int) -> None:
        if not self._has_cfg[server]:
            self._renew(server)
        cl = self.cluster
        jobs_in = cl.jobs[server]
        k1 = bool(self._k1[server])
        jstar = int(self._jstar[server])

        cap = int(cl.capacity[server])
        reserve = (2 * cap + 1) // 3  # 2/3 of this server, grid-rounded

        if k1:
            has_vq1 = any(j.vq == 1 for j in jobs_in.values())
            if not has_vq1:
                head = self.vqs.head(1)
                if head is not None and head.eff_size <= int(cl.residual[server]):
                    self.vqs.pop_head(1)
                    self._place(t, server, head)
                    self._empty.discard(server)
                elif head is None:
                    self._want[1].add(server)

        if jstar >= 0:
            other_cap = cap - reserve if k1 else cap
            vq1_occ = sum(j.eff_size for j in jobs_in.values() if j.vq == 1)
            other_occ = cl.occupancy(server) - vq1_occ
            while True:
                head = self.vqs.head(jstar)
                if head is None:
                    self._want[jstar].add(server)
                    break
                if other_occ + head.eff_size > other_cap:
                    break  # unblocks on this server's own departures
                self.vqs.pop_head(jstar)
                self._place(t, server, head)
                other_occ += head.eff_size
                self._empty.discard(server)

    def queue_len(self):
        return len(self.vqs)
