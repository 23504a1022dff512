"""Self-healing supervision for the streaming runtime (torch port of
``repro.core.engine.supervisor``).

The streaming loop (``core.engine.streaming.stream_policy``) runs
unattended against trace readers, network filesystems and checkpoint
disks — the places transient faults live.  This module is the supervision
layer around it:

  * **Retry with jittered exponential backoff** (:class:`RetryPolicy`) for
    the three host-side operations that fail transiently — chunk ingestion
    (``next()`` on the source iterator), chunk staging (the copy to the
    device) and checkpoint writes.  Every retry is a loud
    :class:`SupervisorWarning` and counted on ``PolicyResult.retries``.
  * **Watchdog timeouts** (:meth:`Supervisor.watch`): per-chunk device
    compute (the wait on a chunk's CUDA event in the depth-2 pipeline) and
    host staging each run under a bounded wall-clock budget; exceeding it
    raises a typed :class:`SupervisorTimeout` naming the phase and chunk.
    A timeout escalates immediately — a hung host or device is not a
    retryable condition.
  * **Checkpoint rollback**: every checkpoint records a SHA-256 of its
    arrays; on supervised resume ``ckpt.latest_valid_step`` walks back
    over truncated or garbled boundaries to the newest checkpoint that
    still verifies, warns (:class:`CheckpointRollbackWarning`) and counts
    the skips on ``PolicyResult.rollbacks`` — and the resumed run is still
    BIT-IDENTICAL to a straight-through one (the skipped chunks simply
    re-execute).
  * **Poison-chunk quarantine**: a chunk that deterministically fails
    after ``RetryPolicy.max_retries`` attempts (or fails staging with a
    non-retryable error) is written to ``quarantine_dir/chunk_<i>/`` with a
    JSON manifest (error, traceback, policy, config) and its stream planes
    when they were readable, then skipped with explicit accounting
    (``PolicyResult.quarantined`` and a :class:`SupervisorWarning`).
    Without a ``quarantine_dir`` the failure propagates instead.
  * **Runtime invariant auditor** (:func:`make_auditor`,
    :func:`audit_result`): an opt-in per-chunk check of the conservation
    laws the engines imply — see :data:`INVARIANTS` — as torch operations
    on the result's device, raising a typed :class:`InvariantViolation`
    naming the chunk index and the failed counter.

:class:`InvariantViolation` subclasses ``ValueError`` on purpose: the
event-driven cluster (``core.cluster_state.Cluster.check_invariants``) and
the serving engine raise this one class where bookkeeping corruption
historically raised ``ValueError``.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ...checkpoint.ckpt import _to_numpy

__all__ = [
    "RetryPolicy", "Supervisor", "SupervisorError", "SupervisorTimeout",
    "SupervisorWarning", "CheckpointRollbackWarning", "InvariantViolation",
    "INVARIANTS", "make_auditor", "audit_result",
]


class SupervisorError(RuntimeError):
    """Supervision gave up: retries exhausted past quarantine limits, or
    a structurally unrecoverable stream."""


class SupervisorTimeout(SupervisorError):
    """A watchdog budget elapsed with the supervised phase still running.

    The abandoned work keeps running on its daemon thread (a hung wait on
    the device cannot be cancelled portably); the escalation is the point
    — a serving loop must never wedge silently."""

    def __init__(self, phase: str, budget_s: float,
                 chunk_index: int | None = None):
        self.phase = phase
        self.budget_s = budget_s
        self.chunk_index = chunk_index
        at = "" if chunk_index is None else f" (chunk {chunk_index})"
        super().__init__(
            f"watchdog: {phase}{at} still running after its "
            f"{budget_s:.3g}s budget")


class InvariantViolation(ValueError):
    """A runtime conservation law failed.  Subclasses ``ValueError`` so
    call sites that expect ``ValueError`` on bookkeeping corruption keep
    working.  ``invariant`` names the failed law; ``chunk_index`` the
    chunk of a streamed run it failed in, where there is one."""

    def __init__(self, message: str, *, invariant: str | None = None,
                 chunk_index: int | None = None):
        self.invariant = invariant
        self.chunk_index = chunk_index
        super().__init__(message)


class SupervisorWarning(UserWarning):
    """Loud, non-fatal supervision events: retries and quarantines."""


class CheckpointRollbackWarning(SupervisorWarning):
    """Corrupt checkpoint boundaries were skipped on resume."""


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered, capped exponential backoff for transient host failures.

    Attempt ``k`` (1-based) sleeps ``min(max_delay, base_delay *
    2**(k-1))`` scaled by a deterministic jitter drawn uniformly from
    ``[1 - jitter, 1]`` (stdlib ``random.Random`` seeded with ``seed``, so
    one seed gives the JAX package's schedule exactly).  ``retryable``
    lists the exception types worth retrying at all; everything else
    escalates immediately."""

    max_retries: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    retryable: tuple = (OSError,)
    seed: int = 0

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay, self.base_delay * 2.0 ** (attempt - 1))
        return d * (1.0 - self.jitter * rng.random())


@dataclass
class Supervisor:
    """Supervision state threaded through one ``stream_policy`` run.

    ``sleep`` is injectable so tests and soak harnesses replay backoff
    schedules without wall-clock cost.  Counters (``retries``,
    ``quarantined``, ``rollbacks``, ``timeouts``) are surfaced on the
    returned ``PolicyResult``; ``events`` keeps the full ordered log for
    forensics (:meth:`report`)."""

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    compute_timeout: float | None = None   # s per pipeline drain
    stage_timeout: float | None = None     # s per ingest/stage attempt
    quarantine_dir: str | None = None
    max_consecutive_quarantines: int = 2
    sleep: Callable[[float], None] = time.sleep

    retries: int = field(default=0, init=False)
    quarantined: int = field(default=0, init=False)
    rollbacks: int = field(default=0, init=False)
    timeouts: int = field(default=0, init=False)
    events: list = field(default_factory=list, init=False)
    _consecutive: int = field(default=0, init=False)

    def __post_init__(self):
        self._rng = random.Random(self.retry.seed)

    # -- watchdog ---------------------------------------------------------
    def watch(self, phase: str, fn: Callable, timeout: float | None,
              chunk_index: int | None = None):
        """Run ``fn()`` under a wall-clock budget; raise
        :class:`SupervisorTimeout` if it is still running afterwards."""
        if timeout is None:
            return fn()
        box: list = []

        def run():
            try:
                box.append(("ok", fn()))
            except BaseException as e:  # surfaced on the caller thread
                box.append(("err", e))

        t = threading.Thread(target=run, daemon=True,
                             name=f"supervised-{phase}")
        t.start()
        t.join(timeout)
        if not box:
            self.timeouts += 1
            self.events.append(("timeout", phase, chunk_index, timeout))
            raise SupervisorTimeout(phase, timeout, chunk_index)
        tag, val = box[0]
        if tag == "err":
            raise val
        return val

    # -- retry ------------------------------------------------------------
    def call(self, kind: str, fn: Callable, *,
             chunk_index: int | None = None,
             timeout: float | None = None):
        """Run ``fn()`` with retry-on-retryable + per-attempt watchdog.

        ``StopIteration`` always propagates (an exhausted source is not a
        failure); :class:`SupervisorTimeout` escalates without retry."""
        attempt = 0
        while True:
            try:
                return self.watch(kind, fn, timeout, chunk_index)
            except self.retry.retryable as e:
                if isinstance(e, (StopIteration, SupervisorTimeout)):
                    raise
                attempt += 1
                self.events.append(
                    ("retry", kind, chunk_index, attempt, repr(e)))
                if attempt > self.retry.max_retries:
                    raise
                self.retries += 1
                delay = self.retry.delay(attempt, self._rng)
                warnings.warn(
                    f"{kind}"
                    + ("" if chunk_index is None
                       else f" (chunk {chunk_index})")
                    + f" failed with {e!r}; retry "
                      f"{attempt}/{self.retry.max_retries} after "
                      f"{delay * 1e3:.1f}ms backoff",
                    SupervisorWarning, stacklevel=3)
                self.sleep(delay)

    # -- quarantine -------------------------------------------------------
    def quarantine(self, src_index: int, error: BaseException, *,
                   streams_chunk=None, policy: str | None = None,
                   config: dict | None = None) -> str:
        """Record chunk ``src_index`` as poison and authorize skipping it.

        Writes ``quarantine_dir/chunk_<i>/manifest.json`` (+ ``chunk.npz``
        stream planes when the chunk was readable) via tmp-then-rename,
        counts the skip, and warns.  Raises :class:`SupervisorError` when
        no ``quarantine_dir`` is configured (nowhere to preserve the
        evidence — skipping would be silent data loss) or when more than
        ``max_consecutive_quarantines`` chunks fail back-to-back (that is
        a broken source, not isolated poison)."""
        if self.quarantine_dir is None:
            raise SupervisorError(
                f"chunk {src_index} is poison ({error!r}) and no "
                "quarantine_dir= is configured; refusing to skip data "
                "without preserving it") from error
        final = os.path.join(self.quarantine_dir,
                             f"chunk_{src_index:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        has_planes = streams_chunk is not None
        if has_planes:
            arrays = {name: _to_numpy(v) for name, v
                      in zip(streams_chunk._fields, tuple(streams_chunk))
                      if v is not None}
            np.savez(os.path.join(tmp, "chunk.npz"), **arrays)
        manifest = {
            "chunk_index": int(src_index),
            "error_type": type(error).__name__,
            "error": str(error),
            "traceback": "".join(traceback.format_exception(
                type(error), error, error.__traceback__)),
            "policy": policy,
            "config": {k: repr(v) for k, v in sorted((config or {})
                                                     .items())},
            "has_planes": has_planes,
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self.quarantined += 1
        self._consecutive += 1
        self.events.append(("quarantine", src_index, repr(error)))
        warnings.warn(
            f"quarantined poison chunk {src_index} to {final} "
            f"({type(error).__name__}: {error}); the stream continues "
            "WITHOUT it (counted on PolicyResult.quarantined)",
            SupervisorWarning, stacklevel=3)
        if self._consecutive > self.max_consecutive_quarantines:
            raise SupervisorError(
                f"{self._consecutive} consecutive chunks quarantined "
                f"(limit {self.max_consecutive_quarantines}) — the source "
                "is broken, not poisoned; aborting instead of skipping "
                "the rest of the stream") from error
        return final

    def mark_chunk_ok(self) -> None:
        self._consecutive = 0

    # -- rollback ---------------------------------------------------------
    def note_rollback(self, corrupt_steps: list[int],
                      checkpoint_dir: str) -> None:
        if not corrupt_steps:
            return
        self.rollbacks += len(corrupt_steps)
        self.events.append(("rollback", tuple(corrupt_steps),
                            checkpoint_dir))
        warnings.warn(
            f"rolled back over {len(corrupt_steps)} corrupt checkpoint "
            f"step(s) {sorted(corrupt_steps)} in {checkpoint_dir}; "
            "resuming from the last good boundary (the skipped chunks "
            "re-execute bit-identically)",
            CheckpointRollbackWarning, stacklevel=3)

    def report(self) -> dict:
        """Accounting snapshot — what a soak harness prints."""
        return {
            "retries": self.retries,
            "quarantined": self.quarantined,
            "rollbacks": self.rollbacks,
            "timeouts": self.timeouts,
            "events": list(self.events),
        }


# -- runtime invariant auditor -------------------------------------------

#: (key, statement) per audited conservation law, in margin order.  The
#: in-flight count is derived — ``arrivals - served - queued - dropped -
#: lost`` — so the two bounds together ARE the paper's job-conservation
#: law ``arrivals == served + queued + dropped + lost + in-flight`` with
#: in-flight confined to the physical ``(L, K)`` server planes every
#: engine carries.
INVARIANTS = (
    ("in_flight_nonneg",
     "arrivals - served - queued - dropped - lost >= 0 (job conservation)"),
    ("in_flight_bound",
     "in-flight jobs <= L*K server slots (job conservation)"),
    ("occupancy_capacity",
     "occupancy <= L*capacity per resource"),
    ("preempted_split",
     "preempted == requeued + lost (fault accounting)"),
    ("queue_nonneg", "queue_len >= 0"),
    ("departed_monotone", "cumulative departures nondecreasing"),
)

#: f32 slack for the capacity margin: occupancy sums are exact on the
#: quantize.RES grid, but the margin subtraction itself is f32.
_AUDIT_EPS = 1e-3


def _check_margins(margins, *, policy: str, chunk_index: int | None,
                   what: str) -> None:
    m = np.asarray(margins, dtype=np.float64)
    bad = np.where(m < -_AUDIT_EPS)[0]
    if bad.size:
        k = int(bad[np.argmin(m[bad])])
        key, law = INVARIANTS[k]
        where = what if chunk_index is None \
            else f"{what} chunk {chunk_index}"
        raise InvariantViolation(
            f"policy {policy!r} violated runtime invariant "
            f"`{key}` ({law}) on {where}: margin {m[k]:.6g} "
            f"(all margins {np.round(m, 4).tolist()}; order "
            f"{[key for key, _ in INVARIANTS]})",
            invariant=key, chunk_index=chunk_index)


def make_auditor(*, policy: str, config: dict, num_resources: int,
                 what: str = "stream"):
    """Build the per-chunk invariant checker.

    Returns ``audit(arr_cum, res, dep_base, chunk_index)`` where
    ``arr_cum`` is the cumulative arrival count through this chunk (per
    ensemble member when batched), ``res`` the chunk's ``PolicyResult``
    (chunk-local planes, whole-run scalar counters — the carry
    accumulates them), and ``dep_base`` the cumulative departures before
    this chunk.  Raises :class:`InvariantViolation` naming the chunk and
    counter.  The margins are float32 torch operations on the result's
    device, in the JAX package's order; reading them syncs the host once
    per chunk, which is why the knob is opt-in."""
    try:
        L, K = int(config["L"]), int(config["K"])
    except KeyError as e:
        raise ValueError(
            "audit needs explicit L= and K= in the run config — the "
            "conservation bounds are physical (L*K server slots, "
            "L*capacity occupancy) and cannot be inferred from engine "
            "defaults") from e
    cap = config.get("capacity", 1.0)
    if not isinstance(cap, (tuple, list)):
        cap = (float(cap),) * num_resources
    cap_total = np.asarray(cap, dtype=np.float32) * L
    max_in_flight = float(L * K)

    def margins(dev, arr_cum, queue_plane, occ_plane, dep_plane, dep_base,
                dropped, lost, preempted, requeued) -> torch.Tensor:
        def f32(x):
            return torch.as_tensor(x, device=dev).to(torch.float32)

        queue_plane = f32(queue_plane)
        q_last = queue_plane[..., -1]
        dep = f32(dep_plane)
        dep_last = f32(dep_base) + dep[..., -1]
        in_flight = f32(arr_cum) - dep_last - q_last - f32(dropped) \
            - f32(lost)
        # occupancy: (T,), (G,T), (T,R) or (G,T,R) — the time axis is the
        # queue plane's last axis
        t_ax = queue_plane.ndim - 1
        occ_margin = (torch.as_tensor(cap_total, device=dev)
                      - f32(occ_plane).amax(dim=t_ax)).min()
        dep_margin = torch.diff(dep, dim=-1).min() if dep.shape[-1] > 1 \
            else torch.zeros((), dtype=torch.float32, device=dev)
        return torch.stack([
            in_flight.min(),
            max_in_flight - in_flight.max(),
            occ_margin,
            -(f32(preempted) - f32(requeued) - f32(lost)).abs().max(),
            queue_plane.min(),
            dep_margin,
        ])

    def audit(arr_cum, res, dep_base, chunk_index=None):
        dev = torch.as_tensor(res.queue_len).device
        zero = torch.zeros_like(torch.as_tensor(res.dropped, device=dev))
        m = margins(dev, arr_cum, res.queue_len, res.occupancy,
                    res.departed, dep_base, res.dropped,
                    zero if res.lost is None else res.lost,
                    zero if res.preempted is None else res.preempted,
                    zero if res.requeued is None else res.requeued)
        _check_margins(m.cpu().numpy(), policy=policy,
                       chunk_index=chunk_index, what=what)

    return audit


def audit_result(streams, res, *, policy: str, config: dict) -> None:
    """Post-hoc invariant audit of a ONE-SHOT run (benches, CI gates):
    the whole horizon is treated as a single chunk.  ``config`` needs the
    ``L``/``K`` (and ``capacity``) the run used.  Raises
    :class:`InvariantViolation`; returns None when every margin holds.

    Not for ``trajectory="tail"`` streaming results — their planes cover
    only the newest chunk while ``streams`` covers the full horizon."""
    n_res = res.occupancy.ndim - res.queue_len.ndim + 1
    cfg = dict(config)
    if cfg.get("capacity") is not None \
            and not isinstance(cfg["capacity"], (tuple, list)):
        cfg["capacity"] = (float(cfg["capacity"]),) * n_res
    audit = make_auditor(policy=policy, config=cfg, num_resources=n_res,
                         what="one-shot run")
    # a partial result (stop_after_chunks) covers fewer slots than the
    # streams — count arrivals only over the horizon the result covers
    T_res = int(res.queue_len.shape[-1])
    arr_cum = torch.as_tensor(streams.n)[..., :T_res].sum(
        dim=-1, dtype=torch.int32)
    audit(arr_cum, res, torch.zeros((), dtype=torch.int32), None)
