"""Non-preemptive MaxWeight oracle for FINITE-type systems ([6],[8],[9]).

Requires the discrete type set up front (sizes + enumeration of ALL feasible
configurations) — exactly the knowledge/complexity the paper's oblivious
algorithms avoid.  Used as the throughput oracle in tests and figure
benchmarks.  Configurations are renewed at server-empty epochs (like VQS).

Copied from ``repro.core.maxweight``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .base import Scheduler
from .queues import Job
from .quantize import RES, to_grid
from .stability import enumerate_configs, maximal_configs


class MaxWeight(Scheduler):
    name = "maxweight"

    def __init__(self, type_sizes, capacity: int = RES, max_configs: int = 500_000):
        sizes = np.asarray(type_sizes)
        self.type_sizes = to_grid(sizes) if sizes.dtype.kind == "f" else sizes.astype(np.int64)
        self.configs = maximal_configs(
            enumerate_configs(self.type_sizes, capacity, max_configs),
            self.type_sizes, capacity)
        self.J = len(self.type_sizes)

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        L = cluster.L
        self.queues: list[deque[Job]] = [deque() for _ in range(self.J)]
        self.qsizes = np.zeros(self.J, dtype=np.int64)
        self._cfg = np.zeros((L, self.J), dtype=np.int64)
        self._has_cfg = np.zeros(L, dtype=bool)
        self._empty: set[int] = set(range(L))
        self._want: list[set[int]] = [set() for _ in range(self.J)]
        return self

    def _type_of(self, size_int: int) -> int:
        j = int(np.argmin(np.abs(self.type_sizes - size_int)))
        if abs(int(self.type_sizes[j]) - size_int) > 2:
            raise ValueError(f"job size {size_int} is not one of the declared types")
        return j

    def make_job(self, jid, size_int, t, dur=0):
        j = self._type_of(size_int)
        return Job(jid, int(self.type_sizes[j]), int(self.type_sizes[j]), j, t, dur)

    def on_arrivals(self, t, jobs):
        self._arrived: set[int] = set()
        for job in jobs:
            self.queues[job.vq].append(job)
            self.qsizes[job.vq] += 1
            self._arrived.add(job.vq)

    def schedule(self, t, freed, emptied):
        woken: set[int] = set()
        for j in self._arrived:
            woken |= self._want[j]
            self._want[j].clear()
        self._arrived = set()
        visit = set(freed) | set(emptied) | woken
        if self.qsizes.sum() > 0 and self._empty:
            visit |= self._empty
        for server in sorted(visit):
            if self.cluster.num_jobs(server) == 0:
                w = self.configs @ self.qsizes
                self._cfg[server] = self.configs[int(np.argmax(w))]
                self._has_cfg[server] = True
                self._empty.add(server)
            self._serve(t, server)

    def _serve(self, t, server):
        if not self._has_cfg[server]:
            w = self.configs @ self.qsizes
            self._cfg[server] = self.configs[int(np.argmax(w))]
            self._has_cfg[server] = True
        cfg = self._cfg[server]
        counts = np.zeros(self.J, dtype=np.int64)
        for job in self.cluster.jobs[server].values():
            counts[job.vq] += 1
        for j in range(self.J):
            while counts[j] < cfg[j]:
                if not self.queues[j]:
                    self._want[j].add(server)
                    break
                job = self.queues[j].popleft()
                self.qsizes[j] -= 1
                self._place(t, server, job)
                self._empty.discard(server)
                counts[j] += 1

    def queue_len(self):
        return int(self.qsizes.sum())
