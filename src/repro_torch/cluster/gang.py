"""Gang scheduler: the paper's algorithm at the POD level (a copy of
``repro.cluster.gang`` on the port's event-driven modules; host numpy, no
device work).

Training jobs with random HBM footprints (model + optimizer bytes as a
fraction of a pod) arrive over time and are packed onto a fixed fleet of
pods with BF-J/S.  On pod failure the victim jobs are re-queued and the
BF-S pass re-packs them onto the survivors — cluster repair IS the paper's
scheduling step.  Jobs resume from their latest checkpoint, so a failure
costs at most the steps since it.  With the same seed, every placement
equals the JAX package's tick for tick (the same Philox generator drives
the same ``BFJS``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.best_fit import BFJS
from ..core.cluster_state import Cluster, ServiceModel
from ..core.queues import Job
from ..core.quantize import to_grid


@dataclass
class TrainJob:
    jid: int
    hbm_frac: float           # fraction of one pod's HBM
    steps_total: int
    steps_done: int = 0
    pod: int = -1
    restarts: int = 0


class GangScheduler:
    """BF-J/S over pods; jobs tick one step per slot; failures re-pack."""

    def __init__(self, num_pods: int, seed: int = 0):
        self.cluster = Cluster(num_pods)
        self.policy = BFJS().bind(self.cluster, ServiceModel("fixed", 1.0),
                                  np.random.Generator(np.random.Philox(seed)))
        self.jobs: dict[int, TrainJob] = {}
        self._cluster_jobs: dict[int, Job] = {}
        self.t = 0

    def submit(self, jobs: list[TrainJob]) -> None:
        cjobs = []
        for j in jobs:
            self.jobs[j.jid] = j
            size = int(to_grid([j.hbm_frac])[0])
            # duration = remaining steps (fixed service)
            cj = Job(j.jid, size, size, -1, self.t,
                     dur=max(j.steps_total - j.steps_done, 1))
            self._cluster_jobs[j.jid] = cj
            cjobs.append(cj)
        self.policy.on_arrivals(self.t, cjobs)

    def tick(self) -> None:
        """One scheduling slot: departures (completed jobs), placements."""
        freed, emptied = self.cluster.process_departures(self.t)
        if not hasattr(self.policy, "_new"):
            self.policy._new = []
        self.policy.schedule(self.t, freed, emptied)
        # progress accounting + placement discovery
        for pod in range(self.cluster.L):
            for cj in self.cluster.jobs[pod].values():
                job = self.jobs[cj.jid]
                job.pod = pod
                job.steps_done += 1
        self.t += 1
        self.policy.on_arrivals(self.t, [])

    def fail_pod(self, pod: int) -> list[int]:
        """Kill a pod: requeue its jobs (they resume from checkpoints)."""
        victims = list(self.cluster.jobs[pod].keys())
        requeue = []
        for jid in victims:
            cj = self.cluster.evict(pod, jid)
            job = self.jobs[jid]
            job.restarts += 1
            job.pod = -1
            nj = Job(jid, cj.size, cj.eff_size, -1, self.t,
                     dur=max(job.steps_total - job.steps_done, 1))
            self._cluster_jobs[jid] = nj
            requeue.append(nj)
        self.policy.on_arrivals(self.t, requeue)
        self.policy.schedule(self.t, {pod}, {pod})
        return victims

    def running(self) -> list[int]:
        return [j.jid for j in self.jobs.values() if j.pod >= 0]

    def queued(self) -> int:
        return self.policy.queue_len()
