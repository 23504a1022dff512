"""VQS-BF — VQS configuration selection + Best-Fit packing (paper Section VI,
Theorem 4: same 2/3 guarantee as VQS, BF-like delay in practice).

Differences from VQS in the job-scheduling step (paper (i)-(iii)):
  (i)   with k_1 = 1 the server schedules the LARGEST VQ_1 job that fits and
        reserves exactly that job's size (no 2/3 reservation when none fits);
  (ii)  the other type j* is served LARGEST-fit-first and stops at k_{j*}
        jobs of that type (or when VQ_{j*} empties / nothing fits);
  (iii) the remaining capacity is filled by BF-S over ALL virtual queues.

Event-driven wake-ups as in VQS, plus an arrival-side BF-J pass: a newly
arrived job that no visited server consumed is offered to the tightest
feasible server (the job-perspective equivalent of step (iii)).

Copied from ``repro.core.vqs_bf``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from .queues import Job
from .vqs import VQS


class VQSBF(VQS):
    name = "vqs-bf"

    def on_arrivals(self, t, jobs):
        super().on_arrivals(t, jobs)
        self._new: list[Job] = list(jobs)

    def schedule(self, t, freed, emptied):
        super().schedule(t, freed, emptied)
        # Arrival-side BF-J pass over jobs still queued.
        cl = self.cluster
        for job in self._new:
            server = cl.tightest_feasible(job.eff_size)
            if server >= 0 and self.vqs.remove_specific(job):
                self._place(t, server, job)
                self._empty.discard(server)
        self._new = []

    def _serve(self, t, server):
        if not self._has_cfg[server]:
            self._renew(server)
        cl = self.cluster
        jobs_in = cl.jobs[server]
        k1 = bool(self._k1[server])
        jstar = int(self._jstar[server])
        kstar = int(self._kstar[server])

        # (i) largest fitting VQ_1 job, reserving exactly its size.
        if k1 and not any(j.vq == 1 for j in jobs_in.values()):
            job = self.vqs.pop_largest_leq(1, int(cl.residual[server]))
            if job is not None:
                self._place(t, server, job)
                self._empty.discard(server)
            elif self.vqs.sizes[1] == 0:
                self._want[1].add(server)

        # (ii) largest-fit-first from VQ_{j*}, stopping at k_{j*} jobs.
        if jstar >= 0:
            count = sum(1 for j in jobs_in.values() if j.vq == jstar)
            while count < kstar:
                job = self.vqs.pop_largest_leq(jstar, int(cl.residual[server]))
                if job is None:
                    if self.vqs.sizes[jstar] == 0:
                        self._want[jstar].add(server)
                    break
                self._place(t, server, job)
                self._empty.discard(server)
                count += 1

        # (iii) BF-S sweep over all VQs into the remaining capacity.
        while True:
            job = self.vqs.pop_largest_leq_any(int(cl.residual[server]))
            if job is None:
                break
            self._place(t, server, job)
            self._empty.discard(server)

    def queue_len(self):
        return len(self.vqs)
