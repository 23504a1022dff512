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
from ..core.engine.supervisor import InvariantViolation
from ..core.quantize import RES
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig

#: ROADMAP item that ports the device-resident admission controller.
LIVE_ADMISSION_TODO = "ROADMAP queue 1 item 10 (serving/live.py)"


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


class ServingEngine:
    """L replicas + paper-scheduler admission; host-level request queue.

    ``admission="host"`` (the default, and the only one ported) runs the
    Python :class:`AdmissionController`.  ``device=None`` means the card.
    """

    def __init__(self, cfg: ModelConfig, params, num_replicas: int = 2,
                 b_slots: int = 4, c_max: int = 128, policy: str = "bf",
                 admission: str = "host", audit: bool = False, device=None):
        if admission == "live":
            raise NotImplementedError(
                "admission=\"live\" (the device-resident controller) is not "
                f"ported yet: {LIVE_ADMISSION_TODO}")
        if admission != "host":
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
        self.admission = AdmissionController(num_replicas, policy=policy)
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
        """One engine tick: decode every replica, release + BF-S refill."""
        finished_all = []
        for idx, rep in enumerate(self.replicas):
            finished = rep.step()
            for r in finished:
                self.completed.append(r)
                self.admission.release(idx, self._job_size[r.rid])
            finished_all.extend(finished)
            if finished:
                for rid, ridx in self.admission.refill(idx):
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
        * admission residuals — nonnegative and within replica capacity.

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
