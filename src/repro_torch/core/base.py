"""Scheduler interface for the event-driven engine.

Copied from ``repro.core.base``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import abc

import numpy as np

from .cluster_state import Cluster, ServiceModel
from .queues import Job


class Scheduler(abc.ABC):
    """A scheduling policy.

    Per-slot protocol (driven by core.simulator.Simulator):
      1. cluster.process_departures(t)   -> freed, emptied
      2. policy.on_arrivals(t, jobs)     -> enqueue new jobs
      3. policy.schedule(t, freed, emptied) -> placements via self._place
    """

    name: str = "scheduler"

    def bind(self, cluster: Cluster, service: ServiceModel, rng: np.random.Generator):
        self.cluster = cluster
        self.service = service
        self.rng = rng
        self._t = 0
        return self

    # -- job classification (subclasses may attach VQ types) --------------
    def make_job(self, jid: int, size_int: int, t: int, dur: int = 0) -> Job:
        return Job(jid, size_int, size_int, -1, t, dur)

    @abc.abstractmethod
    def on_arrivals(self, t: int, jobs: list[Job]) -> None:
        ...

    @abc.abstractmethod
    def schedule(self, t: int, freed: set[int], emptied: set[int]) -> None:
        ...

    @abc.abstractmethod
    def queue_len(self) -> int:
        ...

    def queued_total_size(self) -> int:
        return 0  # optional diagnostic

    # -- helpers -----------------------------------------------------------
    def _place(self, t: int, server: int, job: Job) -> None:
        dur = job.dur if job.dur > 0 else int(self.service.draw(self.rng, 1)[0])
        self.cluster.place(server, job, t + dur)

    def on_place(self, server: int, job: Job) -> None:  # subclass hook
        ...
