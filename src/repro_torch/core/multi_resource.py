"""Multi-resource Best-Fit (paper Section VIII): the event-driven oracle
(numpy copy of ``repro.core.multi_resource``: ``alignment_scores``,
``MRJob`` and ``MultiResourceBFJS``).

The paper's preprocessing collapses (cpu, mem) to max(cpu, mem); Section
VIII suggests instead a Best-Fit score that is the inner product of the
job's requirement vector and the server's resource vector (the Tetris
alignment score):

  score(job, server) = <job_demand, server_available>
  place the job on the FEASIBLE server with the LOWEST score — the
  multi-dimensional "tightest server".

This is the behavioural oracle of the ``policy="bfjs-mr"`` engines
(``core/engine/bfjs_mr.py``).  On grid-quantized demands every score is
exact in float64 (``alignment_scores``) and every occupancy a dyadic
``k / 2**16`` that float64 adds and compares without rounding, so the
oracle and the integer engines agree on every tie-break.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def alignment_scores(avail: np.ndarray, demand: np.ndarray) -> np.ndarray:
    """Tetris alignment <demand, avail> per server, exact float64 form.

    ``avail`` is (L, R), ``demand`` is (R,).  On grid-quantized values
    every product is an integer multiple of ``2**-32`` with magnitude
    below R — at most ~34 of float64's 53 mantissa bits — so each product
    AND every partial sum is exact, making the result independent of
    accumulation order, SIMD width and backend.  The torch engines and the
    CUDA kernel compare the identical scores as an exact int32 pair
    (``engine.ops.alignment_score_pair``), so argmin tie-breaks agree
    everywhere.
    """
    prods = avail.astype(np.float64) * demand.astype(np.float64)[None, :]
    return prods.sum(axis=1)


@dataclass
class MRJob:
    jid: int
    demand: np.ndarray        # (R,) in (0, 1]^R
    arrival: int
    dur: int = 0
    tries: int = 0            # completed requeue attempts (fault preemption)
    dep_time: int = -1        # scheduled departure slot while in service
    seq: int = -1             # queue-ordering id; refreshed on each requeue


class MultiResourceBFJS:
    """BF-J/S with the alignment score over R resources.

    BF-S step (freed servers): repeatedly place the queued job with the
    largest total demand that fits.  BF-J step (new jobs): place on the
    feasible server with the lowest alignment score.
    """

    name = "mr-bf-js"

    def __init__(self, L: int, num_resources: int,
                 capacity: float | tuple[float, ...] = 1.0):
        self.L = L
        self.R = num_resources
        self.capacity = np.broadcast_to(
            np.asarray(capacity, dtype=np.float64), (num_resources,)).copy()
        self.occupied = np.zeros((L, num_resources))
        self.jobs: list[dict[int, MRJob]] = [dict() for _ in range(L)]
        self.queue: dict[int, MRJob] = {}
        self._dep: dict[int, list[tuple[int, int]]] = {}
        # fault-preemption accounting (invariant: preempted == requeued
        # + lost) and the queue-ordering seq counter: every queue
        # insertion — arrival or requeue — takes the next seq, so dict
        # iteration order is always ascending seq (what the scan engine's
        # qseq tie-breaks reproduce).
        self.preempted = 0
        self.requeued = 0
        self.lost = 0
        self._seq = 0
        self._down_last = np.zeros(L, dtype=bool)

    # -- scores -------------------------------------------------------------
    def _feasible(self, demand: np.ndarray) -> np.ndarray:
        return (self.occupied + demand[None, :]
                <= self.capacity[None, :] + 1e-12).all(axis=1)

    def _best_server(self, demand: np.ndarray,
                     down: np.ndarray | None = None) -> int:
        feas = self._feasible(demand)
        if down is not None:
            feas = feas & ~down
        if not feas.any():
            return -1
        avail = self.capacity[None, :] - self.occupied
        # tightest-in-needed-dims = argmin of the exact alignment score
        # (order-independent — see alignment_scores)
        scores = alignment_scores(avail, demand)
        scores[~feas] = np.inf
        return int(np.argmin(scores))

    def _best_job(self, server: int) -> MRJob | None:
        """BF-S: the LARGEST queued job (by total demand) that fits —
        the multi-resource analogue of largest-fitting-first."""
        if not self.queue:
            return None
        occ = self.occupied[server]
        best, best_s = None, -np.inf
        for job in self.queue.values():
            if np.all(occ + job.demand <= self.capacity + 1e-12):
                s = float(job.demand.sum())
                if s > best_s:
                    best, best_s = job, s
        return best

    # -- engine ---------------------------------------------------------------
    def _place(self, t: int, server: int, job: MRJob) -> None:
        self.occupied[server] += job.demand
        self.jobs[server][job.jid] = job
        job.dep_time = t + max(job.dur, 1)
        self._dep.setdefault(job.dep_time, []).append((server, job.jid))

    def step(self, t: int, new_jobs: list[MRJob],
             down: np.ndarray | None = None,
             max_requeue: int = 2) -> None:
        """One slot: departures, fault preemption, arrivals, BF-S, BF-J.

        ``down`` marks servers whose capacity is lost this slot (fault
        plane); every job in service there is preempted — requeued with
        its REMAINING duration while ``tries < max_requeue``, counted
        ``lost`` otherwise.  Victims are processed in ascending ``seq``
        order so requeues re-enter the queue exactly where the scan
        engine's fresh-seq scatter puts them.  Down servers never receive
        placements; a server recovering (down last slot, up now) rejoins
        the BF-S freed set."""
        freed = set()
        for server, jid in self._dep.pop(t, []):
            job = self.jobs[server].pop(jid)
            self.occupied[server] -= job.demand
            freed.add(server)
        self.occupied = np.clip(self.occupied, 0.0, None)
        down = (np.zeros(self.L, dtype=bool) if down is None
                else np.asarray(down, dtype=bool))
        victims = []
        for server in np.flatnonzero(down):
            for jid, job in self.jobs[server].items():
                victims.append((job.seq, int(server), jid))
        for _, server, jid in sorted(victims):
            job = self.jobs[server].pop(jid)
            self.occupied[server] -= job.demand
            self._dep[job.dep_time].remove((server, jid))
            self.preempted += 1
            if job.tries < max_requeue:
                job.tries += 1
                job.dur = max(job.dep_time - t, 1)
                job.seq = self._seq
                self._seq += 1
                self.queue[jid] = job
                self.requeued += 1
            else:
                self.lost += 1
        if victims:
            self.occupied = np.clip(self.occupied, 0.0, None)
        recovered = self._down_last & ~down
        freed |= {int(s) for s in np.flatnonzero(recovered)}
        freed -= {int(s) for s in np.flatnonzero(down)}
        self._down_last = down
        for job in new_jobs:
            job.seq = self._seq
            self._seq += 1
            self.queue[job.jid] = job
        # BF-S over freed (and just-recovered) servers
        for server in sorted(freed):
            while True:
                job = self._best_job(server)
                if job is None:
                    break
                del self.queue[job.jid]
                self._place(t, server, job)
        # BF-J over new arrivals still queued
        for job in new_jobs:
            if job.jid in self.queue:
                server = self._best_server(job.demand, down)
                if server >= 0:
                    del self.queue[job.jid]
                    self._place(t, server, job)

    def queue_len(self) -> int:
        return len(self.queue)
