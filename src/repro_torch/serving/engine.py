"""Continuous-batching serving engine with paper-scheduler admission (the
port of ``repro.serving.engine``).

Each replica holds a batched ragged decode step (one position per cache
slot) over B_slots cache slots of C_max tokens.  A request needs
(prompt_len + max_new) tokens of KV memory = a fraction of the replica's
cache — the paper's job size.  Admission runs BF-J/S
(``cluster/admission.py``): BF-J on arrival, BF-S on completion.

The engine is single-host but replica-sharded by construction: each
replica owns its params reference, cache pool and slot map.  Replicas may
share one parameter dictionary (the weights are only read).

As in the JAX engine, a slot's cache is never reset: a finished request
leaves its state behind, and empty slots keep decoding token 0.  For an
attention model that is harmless (a new request overwrites the rows it
attends to); for a Mamba model the next request in the slot starts from
the SSM and conv state left there.  The port keeps that behaviour so
that its tokens and caches equal the JAX engine's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..cluster.admission import AdmissionController, PendingJob
from ..core.engine import (Workload, apply_tuned, monte_carlo_policy,
                           resolve_mesh)
from ..core.engine.supervisor import InvariantViolation
from ..core.quantize import RES
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .live import LiveAdmission


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    out: list = field(default_factory=list)
    replica: int = -1
    slot: int = -1
    pos: int = 0                # tokens generated so far (incl. prompt fill)
    done: bool = False

    @property
    def tokens_needed(self) -> int:
        return len(self.prompt) + self.max_new


class Replica:
    def __init__(self, cfg: ModelConfig, params, b_slots: int, c_max: int,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.b_slots = b_slots
        self.c_max = c_max
        self.device = resolve_device(device)
        self.caches = M.init_cache(cfg, b_slots, c_max, self.device)
        self.slots: list[Request | None] = [None] * b_slots
        self.positions = np.zeros(b_slots, dtype=np.int32)

    def free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def decode(self, toks: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """One batched decode over every slot: token ``toks[i]`` at position
        ``positions[i]``; returns each slot's greedy next token.  Empty
        slots decode too (token 0 at position 0, as in the JAX engine,
        which writes their cache slot 0)."""
        tok = torch.from_numpy(toks.copy()).to(self.device)[:, None]
        pos = torch.from_numpy(positions.copy()).to(self.device)
        logits, self.caches = M.decode_step(self.params, self.cfg, tok, pos,
                                            self.caches)
        return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()

    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active():
            return []
        toks = np.zeros(self.b_slots, dtype=np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.pos < len(r.prompt):          # prompt feed (teacher forcing)
                toks[i] = r.prompt[r.pos]
            else:
                toks[i] = r.out[-1] if r.out else r.prompt[-1]
        next_toks = self.decode(toks, self.positions)
        finished = []
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            self.positions[i] += 1
            r.pos += 1
            if r.pos >= len(r.prompt):
                r.out.append(int(next_toks[i]))
            if len(r.out) >= r.max_new or r.pos >= self.c_max:
                r.done = True
                finished.append(r)
                self.slots[i] = None
                self.positions[i] = 0
        return finished


def estimate_capacity(num_replicas: int, lam: float,
                      mean_service_slots: float, size_sampler=None, *,
                      ensembles: int = 8, horizon: int = 2_000,
                      policy: str = "bfjs", engine: str = "scan",
                      workload=None, seed: int = 0, K: int = 16,
                      Qcap: int = 512, A_max: int = 8,
                      mesh=None, devices=None, device=None,
                      **policy_config) -> dict:
    """Monte-Carlo what-if sizing for a serving fleet.

    Simulates admission under ``policy`` ("bfjs" — the controller this
    engine runs — or any registered policy, e.g. "vqs", or "bfjs-mr" for
    vector requests) on ``num_replicas`` replicas under Poisson(``lam``)
    request arrivals whose KV-cache fractions come from
    ``size_sampler(generator, n, device)`` (default U[0.05, 0.5]) and whose
    decode lengths are geometric with mean ``mean_service_slots``, with the
    ``engine=`` ("scan" | "cuda" | "reference") the policy runs on, on
    ``device`` (default: the card).  Pass ``workload=`` to size an explicit
    :class:`~repro_torch.core.engine.Workload` instead of the loose knobs,
    which are then ignored.  Extra keyword arguments (``J=`` for VQS) pass
    through to the policy runner.  Returns tail-queue and drop statistics
    that answer "how many replicas does this traffic need?" before any
    model is loaded.

    Member g of the ensemble is seeded with word g of
    ``numpy.random.SeedSequence(seed).generate_state(ensembles)``.
    ``mesh=``/``devices=`` split the ensemble over devices (bit-identical
    results, ``core.engine.sharding``); the tuning cache fills an unset
    ``work_steps`` (``core.engine.tuning``), and the returned dict reports
    ``devices``, ``tuned`` and ``cache_hit`` so a sizing run names its
    launch configuration.
    """
    if workload is None:
        if size_sampler is None:
            def size_sampler(gen, n, device):
                return torch.rand(n, generator=gen, device=device) \
                    * 0.45 + 0.05
        workload = Workload(lam=lam, mu=1.0 / mean_service_slots,
                            sampler=size_sampler)

    mesh = resolve_mesh(mesh, devices)
    policy_config.update(L=num_replicas, K=K, Qcap=Qcap, A_max=A_max,
                         horizon=horizon, device=device)
    tuning_meta = apply_tuned(policy, engine, policy_config,
                              workload.num_resources,
                              backend=None if mesh is None else mesh[0].type)
    seeds = np.random.SeedSequence(seed).generate_state(ensembles).tolist()
    res = monte_carlo_policy(workload, seeds, policy=policy, engine=engine,
                             mesh=mesh, **policy_config)
    tail = res.queue_len[:, -max(horizon // 4, 1):].cpu().numpy()
    return {
        "replicas": num_replicas,
        "policy": policy,
        "engine": engine,
        "devices": 1 if mesh is None else len(mesh),
        "tuned": tuning_meta["tuned"],
        "cache_hit": tuning_meta["cache_hit"],
        "mean_tail_queue": float(tail.mean()),
        "p95_tail_queue": float(np.percentile(tail, 95)),
        "mean_occupancy": float(res.occupancy.double().mean()),
        "dropped": int(res.dropped.sum()),
        "truncated": int(res.truncated.sum()),
        "slots_simulated": ensembles * horizon,
    }


class ServingEngine:
    """L replicas + paper-scheduler admission; host-level request queue.

    ``admission="host"`` (default) runs the Python
    :class:`AdmissionController`; ``admission="live"`` swaps in the
    device-resident controller (``serving/live.py``) on the engine's
    device — identical placements, but each tick's release + BF-S refill
    decisions run as ONE kernel launch instead of a host loop, and the
    host only reads back the placement vector.  ``device=None`` means the
    card.
    """

    def __init__(self, cfg: ModelConfig, params, num_replicas: int = 2,
                 b_slots: int = 4, c_max: int = 128, policy: str = "bf",
                 admission: str = "host", audit: bool = False, device=None):
        if admission not in ("host", "live"):
            raise ValueError(f"unknown admission {admission!r}; expected "
                             '"host" or "live"')
        self.cfg = cfg
        #: opt-in runtime invariant auditor: every tick checks request
        #: conservation + slot-map consistency and raises a typed
        #: InvariantViolation instead of serving on corrupt state
        self.audit = audit
        device = resolve_device(device)
        self.replicas = [Replica(cfg, params, b_slots, c_max, device)
                         for _ in range(num_replicas)]
        if admission == "host":
            self.admission = AdmissionController(num_replicas, policy=policy)
        else:
            self.admission = LiveAdmission(
                num_replicas, tick_width=num_replicas * b_slots,
                device=device)
        self._live = admission == "live"
        self.c_max = c_max
        self._by_rid: dict[int, Request] = {}
        self._job_size: dict[int, int] = {}
        self.completed: list[Request] = []
        self.stats = {"queue_len": [], "active": [], "admitted": 0,
                      "rejected_slots": 0}

    # -- paper job model ----------------------------------------------------
    def _to_job(self, req: Request) -> PendingJob:
        frac = min(req.tokens_needed / self.c_max, 1.0)
        return PendingJob(rid=req.rid, frac=frac)

    def submit(self, reqs: list[Request]) -> None:
        jobs = []
        for r in reqs:
            self._by_rid[r.rid] = r
            job = self._to_job(r)
            self._job_size[r.rid] = job.size
            jobs.append(job)
        for rid, replica in self.admission.admit(jobs):
            self._start(rid, replica)

    def _start(self, rid: int, replica_idx: int) -> None:
        req = self._by_rid[rid]
        rep = self.replicas[replica_idx]
        slot = rep.free_slot()
        if slot < 0:
            # memory admitted but no batch slot: return to queue front
            self.admission.release(replica_idx, self._job_size[rid])
            self.admission.push_front(self._to_job(req))
            self.stats["rejected_slots"] += 1
            return
        req.replica, req.slot = replica_idx, slot
        rep.slots[slot] = req
        rep.positions[slot] = 0
        self.stats["admitted"] += 1

    def step(self) -> list[Request]:
        """One engine tick: decode every replica, release + BF-S refill.

        With ``admission="live"`` the whole tick's releases and refills
        are one launch (``LiveAdmission.tick``); the order is equivalent to
        the host path's — a refill reads only its own replica's residual,
        and refills run in ascending replica order either way."""
        finished_all = []
        events = []
        for idx, rep in enumerate(self.replicas):
            finished = rep.step()
            for r in finished:
                self.completed.append(r)
                if self._live:
                    events.append((idx, self._job_size[r.rid]))
                else:
                    self.admission.release(idx, self._job_size[r.rid])
            finished_all.extend(finished)
            if finished and not self._live:
                for rid, ridx in self.admission.refill(idx):
                    self._start(rid, ridx)
        if self._live and events:
            for rid, ridx in self.admission.tick(events):
                self._start(rid, ridx)
        self.stats["queue_len"].append(self.admission.queue_len())
        self.stats["active"].append(
            sum(len(rep.active()) for rep in self.replicas))
        if self.audit:
            self.check_invariants()
        return finished_all

    def check_invariants(self) -> None:
        """Audit the engine's conservation laws (``audit=True`` runs this
        every tick; callable directly for forensics):

        * request conservation — every submitted request is exactly one
          of queued / active-in-a-slot / completed;
        * slot-map consistency — each resident request's recorded
          ``(replica, slot)`` matches where it actually sits;
        * admission residuals — nonnegative and within replica capacity
          (``admission="live"`` also reads its device-side invalid-release
          counter through ``queue_len``).

        Raises :class:`InvariantViolation` (a ``ValueError``) naming the
        failed counter.
        """
        active = 0
        for idx, rep in enumerate(self.replicas):
            for slot, r in enumerate(rep.slots):
                if r is None:
                    continue
                active += 1
                if r.replica != idx or r.slot != slot:
                    raise InvariantViolation(
                        f"slot map corrupt: request {r.rid} sits in "
                        f"replica {idx} slot {slot} but records "
                        f"(replica={r.replica}, slot={r.slot})",
                        invariant="slot_map")
                if r.done:
                    raise InvariantViolation(
                        f"request {r.rid} is done but still occupies "
                        f"replica {idx} slot {slot}",
                        invariant="slot_map")
        queued = self.admission.queue_len()
        done = len(self.completed)
        submitted = len(self._by_rid)
        if queued + active + done != submitted:
            raise InvariantViolation(
                f"request conservation failed: queued {queued} + active "
                f"{active} + completed {done} != submitted {submitted}",
                invariant="request_conservation")
        residual = np.asarray(self.admission.residual)
        if (residual < 0).any():
            raise InvariantViolation(
                f"negative admission residual(s): {residual.tolist()}",
                invariant="queue_nonneg")
        if (residual > RES).any():
            raise InvariantViolation(
                f"admission residual(s) exceed replica capacity {RES}: "
                f"{residual.tolist()}",
                invariant="occupancy_capacity")

    def run(self, max_steps: int = 1000) -> list[Request]:
        for _ in range(max_steps):
            self.step()
            if not any(rep.active() for rep in self.replicas) \
                    and self.admission.queue_len() == 0:
                break
        return self.completed


#: The serving fleet IS the paper's cluster of L unit-capacity servers.
Cluster = ServingEngine
