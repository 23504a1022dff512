"""FIFO-FF baseline (paper Section VII.B).

Jobs are served strictly in arrival order: the head-of-line job is packed
into the FIRST server (lowest index) with sufficient residual capacity
(First-Fit); if it fits nowhere the queue blocks (head-of-line blocking) —
this is the paper's strengthened version of Hadoop's slot-based FIFO.

Copied from ``repro.core.fifo``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from .base import Scheduler
from .queues import FIFOJobQueue


class FIFOFF(Scheduler):
    name = "fifo-ff"

    def bind(self, cluster, service, rng):
        super().bind(cluster, service, rng)
        self.queue = FIFOJobQueue()
        return self

    def on_arrivals(self, t, jobs):
        for job in jobs:
            self.queue.push(job)

    def schedule(self, t, freed, emptied):
        cl = self.cluster
        while True:
            job = self.queue.head()
            if job is None:
                return
            server = cl.first_fit(job.eff_size)
            if server < 0:
                return  # head-of-line blocking
            self.queue.pop()
            self._place(t, server, job)

    def queue_len(self):
        return len(self.queue)
