"""Slotted-time discrete-event simulator (paper Section II queueing model).

Per slot t: (1) departures complete, (2) the arrival set A(t) joins the
queue, (3) the policy schedules D(t) jobs into servers — Eq. (2)/(3).

Copied from ``repro.core.simulator``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .base import Scheduler
from .cluster_state import Cluster, ServiceModel, poisson_arrivals
from .distributions import JobSizeDistribution
from .quantize import RES, to_grid


@dataclass
class SimResult:
    name: str
    horizon: int
    record_every: int
    queue_lens: np.ndarray
    arrived: int
    departed: int
    utilization: float            # mean fraction of total capacity occupied
    mean_queue: float             # time-average queue length (whole run)
    mean_queue_tail: float        # time-average over the last half (stationary-ish)
    final_queue: int
    extras: dict = field(default_factory=dict)

    def summary(self) -> str:
        return (f"{self.name}: mean_Q={self.mean_queue:.1f} "
                f"tail_Q={self.mean_queue_tail:.1f} final_Q={self.final_queue} "
                f"util={self.utilization:.3f} dep={self.departed}/{self.arrived}")


def simulate(policy: Scheduler,
             L: int,
             lam: float,
             dist: JobSizeDistribution,
             service: ServiceModel,
             horizon: int,
             seed: int = 0,
             capacities: np.ndarray | None = None,
             record_every: int = 1,
             check_invariants: bool = False) -> SimResult:
    """Run `policy` on Poisson(lam) arrivals with iid sizes ~ dist."""
    rng = np.random.Generator(np.random.Philox(seed))
    cluster = Cluster(L, capacities)
    policy.bind(cluster, service, rng)
    arrivals = poisson_arrivals(lam)

    records: list[int] = []
    qsum = 0.0
    qsum_tail = 0.0
    tail_start = horizon // 2
    arrived = 0
    jid = 0

    for t in range(horizon):
        freed, emptied = cluster.process_departures(t)
        n = arrivals(rng)
        if n > 0:
            sizes = to_grid(dist.sample(rng, n))
            jobs = [policy.make_job(jid + i, int(sizes[i]), t) for i in range(n)]
            jid += n
            arrived += n
        else:
            jobs = []
        policy.on_arrivals(t, jobs)
        policy.schedule(t, freed, emptied)
        cluster.accumulate_utilization()
        q = policy.queue_len()
        qsum += q
        if t >= tail_start:
            qsum_tail += q
        if t % record_every == 0:
            records.append(q)
        if check_invariants and t % 997 == 0:
            cluster.check_invariants()

    total_cap = float(cluster.capacity.sum())
    return SimResult(
        name=policy.name,
        horizon=horizon,
        record_every=record_every,
        queue_lens=np.asarray(records, dtype=np.int64),
        arrived=arrived,
        departed=cluster.departed_jobs,
        utilization=cluster.busy_area / (total_cap * horizon),
        mean_queue=qsum / horizon,
        mean_queue_tail=qsum_tail / max(horizon - tail_start, 1),
        final_queue=policy.queue_len(),
    )


def simulate_trace(policy: Scheduler,
                   L: int,
                   arrival_slots: np.ndarray,
                   sizes: np.ndarray,
                   durations: np.ndarray,
                   horizon: int | None = None,
                   seed: int = 0,
                   capacities: np.ndarray | None = None,
                   record_every: int = 100) -> SimResult:
    """Replay a trace: job i arrives at slot arrival_slots[i] with float size
    sizes[i] in (0,1] and fixed service duration durations[i] (slots)."""
    rng = np.random.Generator(np.random.Philox(seed))
    cluster = Cluster(L, capacities)
    service = ServiceModel("fixed", 1.0)  # unused: every job carries dur
    policy.bind(cluster, service, rng)

    order = np.argsort(arrival_slots, kind="stable")
    arrival_slots = np.asarray(arrival_slots)[order]
    sizes_int = to_grid(np.asarray(sizes)[order])
    durations = np.maximum(np.asarray(durations)[order].astype(np.int64), 1)
    n_jobs = len(arrival_slots)
    if horizon is None:
        horizon = int(arrival_slots[-1]) + 1

    records: list[int] = []
    qsum = 0.0
    qsum_tail = 0.0
    tail_start = horizon // 2
    ptr = 0
    for t in range(horizon):
        freed, emptied = cluster.process_departures(t)
        jobs = []
        while ptr < n_jobs and arrival_slots[ptr] <= t:
            jobs.append(policy.make_job(ptr, int(sizes_int[ptr]), t,
                                        dur=int(durations[ptr])))
            ptr += 1
        policy.on_arrivals(t, jobs)
        policy.schedule(t, freed, emptied)
        cluster.accumulate_utilization()
        q = policy.queue_len()
        qsum += q
        if t >= tail_start:
            qsum_tail += q
        if t % record_every == 0:
            records.append(q)

    total_cap = float(cluster.capacity.sum())
    return SimResult(
        name=policy.name,
        horizon=horizon,
        record_every=record_every,
        queue_lens=np.asarray(records, dtype=np.int64),
        arrived=ptr,
        departed=cluster.departed_jobs,
        utilization=cluster.busy_area / (total_cap * horizon),
        mean_queue=qsum / horizon,
        mean_queue_tail=qsum_tail / max(horizon - tail_start, 1),
        final_queue=policy.queue_len(),
    )
