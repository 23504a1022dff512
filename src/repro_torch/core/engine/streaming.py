"""Streaming runtime: unbounded arrival iterators through the scan engines
(torch port of ``repro.core.engine.streaming``).

Every other entry point replays a fixed-``T`` pre-materialized stream; the
paper's setting (Section III) is an *unbounded* arrival process served
online.  :func:`stream_policy` iterates chunks of any — possibly infinite —
``SchedStreams`` iterator through the stateful scan engines, threading the
complete carried state between chunks exactly as ``core.engine.chunked``
does, so

    **streaming replay of any finite trace is BIT-IDENTICAL to the
    one-shot ``run_policy_streams`` run, under any chunking.**

What streaming adds over ``run_chunked`` is the *pipeline*:

  * **Double-buffered ingestion.**  While the device computes chunk N the
    host pulls chunk N+1 from the iterator and stages it: on a card, a copy
    from pinned host memory with ``non_blocking=True`` on a side CUDA
    stream, which the compute stream waits on through an event.  At most
    two chunks are in flight (the host waits on chunk N-1's completion
    event before dispatching N+1), which bounds host memory for infinite
    iterators to O(2 chunks), not O(T).
  * **Backpressure counters.**  The returned :class:`PolicyResult` carries
    ``chunks_behind`` — chunks whose device compute had finished (its CUDA
    event queried complete) before the host had the NEXT chunk staged —
    and ``host_stall_us`` — the total host time spent blocked waiting on
    device compute.  Both measure host/device overlap only: the trajectory
    never depends on timing.  The port's scan engines read a flag from the
    device inside each slot, so on a card little compute overlaps staging
    and ``chunks_behind`` is high by construction; on the CPU every chunk
    is done when dispatch returns.
  * **Bounded-memory trajectories.**  ``trajectory="full"`` concatenates
    per-chunk planes (the default).  ``trajectory="tail"`` keeps only the
    newest chunk's planes — with the cumulative ``departed`` offset folded
    in and the scalar counters already whole-run totals — so an unbounded
    run holds O(chunk), not O(elapsed horizon).

Engines: ``"scan"`` is the streaming engine (its carry is the entire
simulation state).  ``"cuda"`` is rejected with a ``ValueError``, as the
chunked ``run_policy_streams`` rejects it: the kernels keep a member's
state in shared memory for one launch and cannot thread it across
chunks, and no request on the card is served by the scan engine in their
place.  ``"reference"`` keeps host-side state and is rejected too.

``checkpoint_dir=`` persists the carry at every chunk boundary (the
atomic contract of chunked sweeps); ``resume=True`` re-iterates the
source, skips the chunks already executed — verifying the first chunk's
fingerprint so a checkpoint never continues a different stream — and
continues bit-exactly.

``supervisor=`` (a :class:`~repro_torch.core.engine.supervisor.Supervisor`)
makes the loop self-healing — retry/backoff on transient ingestion,
staging and checkpoint-write failures, watchdog timeouts on device compute
and host staging, rollback over corrupt checkpoints on resume, poison-chunk
quarantine — and ``audit=True`` turns on the per-chunk invariant auditor.
Both are opt-in and leave the unsupervised path unchanged.
"""
from __future__ import annotations

import time
import types
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ...checkpoint import ckpt
from ...device import resolve_device
from .chunked import (_STATEFUL, _append, _load_step, _payload, _save_step,
                      _slice_streams, streams_fingerprint)
from .streams import PolicyResult, SchedStreams
from .supervisor import (Supervisor, SupervisorError, SupervisorTimeout,
                         make_auditor)
from .tuning import apply_tuned

#: The engines' dtypes for each stream plane (n, sizes, durs, up).
_PLANE_DTYPES = (torch.int32, torch.float32, torch.int32, torch.bool)


def iter_stream_chunks(streams: SchedStreams, chunk: int
                       ) -> Iterator[SchedStreams]:
    """Slice a materialized ``SchedStreams`` into contiguous time chunks —
    the trivial chunk source (tests, benches, replaying an in-memory
    sweep through :func:`stream_policy`).  Ensemble-batched streams
    (leading G axis) slice along their time axis."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    ensemble = streams.n.ndim == 2
    T = int(streams.n.shape[-1])
    for lo in range(0, T, chunk):
        yield _slice_streams(streams, lo, min(lo + chunk, T), ensemble)


def stream_chunks_from_trace(traces: Iterable, *, chunk_slots: int,
                             A_max: int, collapse: bool = True,
                             num_resources: int | None = None
                             ) -> Iterator[SchedStreams]:
    """Re-bucket an iterator of :class:`~repro_torch.core.trace.Trace`
    chunks (e.g. ``core.trace.iter_trace_csv`` output, chunked by ROW
    COUNT) into fixed ``chunk_slots``-slot ``SchedStreams`` windows for
    :func:`stream_policy`.  The windows are host (CPU) tensors:
    ``stream_policy`` stages each to its device.

    The two chunkings disagree by construction — a CSV reader cuts on
    rows, the engines need contiguous time windows — so arrivals are
    buffered until a window's end has provably passed (arrival slots are
    non-decreasing across reader chunks; the reader validates that) and
    emitted window by window, INCLUDING all-empty windows for slot gaps
    longer than a window: time must advance for in-service durations to
    tick.  Only the not-yet-emitted rows are ever held — constant memory.

    ``A_max`` is mandatory: a streaming source cannot know the global
    per-slot arrival peak in advance, and the engines' carry must keep one
    shape across chunks.  A window whose peak exceeds it raises (streams
    never drop trace jobs silently).  The final window is trimmed to the
    last arrival's slot, so the concatenated horizon equals the one-shot
    ``streams_from_trace`` horizon and trajectories bit-match.

    ``collapse=True`` applies the paper's max(cpu, mem) preprocessing;
    ``collapse=False`` keeps (cpu, mem) requirement vectors
    (``policy="bfjs-mr"``).  ``num_resources`` pins the expected R exactly
    as ``streams_from_trace`` does.

    The returned iterator is a CLASS, not a generator, on purpose: a
    failure raised by the inner ``traces`` source propagates without
    killing the re-bucketing state, so when the source is itself
    idempotent-on-failure (``core.trace.ResumableTraceReader``) the whole
    composition is retryable by the streaming supervisor — and a
    ``skip()`` on the source is forwarded for poison-chunk quarantine.
    """
    if chunk_slots <= 0:
        raise ValueError(f"chunk_slots must be positive, got {chunk_slots}")
    R = 1 if collapse else 2
    if num_resources is not None and num_resources != R:
        raise ValueError(
            f"collapse={collapse} yields R={R} resource plane(s) but "
            f"num_resources={num_resources} was requested")
    return _TraceChunkSource(iter(traces), chunk_slots, A_max, collapse,
                             num_resources)


class _TraceChunkSource:
    """The re-bucketing iterator behind :func:`stream_chunks_from_trace`.

    State (arrival buffer, window cursor, pending completed windows) only
    advances on a SUCCESSFUL pull from the inner source, so an exception
    from ``next(traces)`` leaves this iterator retryable — re-calling
    ``__next__`` re-attempts the same inner pull (the supervisor's
    idempotent-source contract, which a plain generator cannot satisfy).
    """

    def __init__(self, traces, chunk_slots: int, A_max: int,
                 collapse: bool, num_resources: int | None):
        self.traces = traces
        self.chunk_slots = chunk_slots
        self.A_max = A_max
        self.collapse = collapse
        self.num_resources = num_resources
        R = 1 if collapse else 2
        self.buf_slots = np.empty((0,), dtype=np.int64)
        self.buf_sizes = np.empty((0,) if collapse else (0, R),
                                  dtype=np.float64)
        self.buf_durs = np.empty((0,), dtype=np.int64)
        self.win_lo = 0      # first slot of the next window to emit
        self.last_slot = -1  # newest slot seen (slots are non-decreasing)
        self._pending: deque = deque()
        self._exhausted = False
        self._inner_failed = False

    def __iter__(self):
        return self

    def skip(self) -> None:
        """Advance the inner source past a poison chunk (supervised
        quarantine protocol) when it supports skipping."""
        skip = getattr(self.traces, "skip", None)
        if skip is not None:
            skip()

    def _emit(self, hi_slots: int) -> SchedStreams:
        """Emit the window [win_lo, win_lo + hi_slots) from the buffer."""
        from .streams import streams_from_trace

        take = self.buf_slots < self.win_lo + hi_slots
        win = streams_from_trace(
            self.buf_slots[take] - self.win_lo, self.buf_sizes[take],
            self.buf_durs[take], horizon=hi_slots, A_max=self.A_max,
            num_resources=self.num_resources, device="cpu")
        self.buf_slots = self.buf_slots[~take]
        self.buf_sizes = self.buf_sizes[~take]
        self.buf_durs = self.buf_durs[~take]
        self.win_lo += hi_slots
        return win

    def __next__(self) -> SchedStreams:
        while not self._pending and not self._exhausted:
            try:
                tr = next(self.traces)
            except StopIteration:
                if self._inner_failed \
                        and isinstance(self.traces, types.GeneratorType):
                    # a plain generator dies on its first error; its
                    # post-failure StopIteration is death, not a clean end
                    raise SupervisorError(
                        "trace source raised StopIteration right after "
                        "failing: a plain generator dies on its first "
                        "error and cannot be retried — wrap the source "
                        "in a resumable reader (e.g. "
                        "core.trace.ResumableTraceReader)") from None
                self._exhausted = True
                if len(self.buf_slots):
                    # final window: trim to the last arrival so the
                    # concatenated horizon equals the one-shot
                    # streams_from_trace horizon
                    self._pending.append(
                        self._emit(self.last_slot - self.win_lo + 1))
                break
            except BaseException:
                self._inner_failed = True
                raise
            self._inner_failed = False
            slots = np.asarray(tr.arrival_slots, dtype=np.int64)
            if len(slots) == 0:
                continue
            if slots[0] < self.last_slot:
                raise ValueError(
                    f"trace chunks went backwards in time: slot "
                    f"{slots[0]} after {self.last_slot} (the reader "
                    "guarantees monotone arrivals — did chunks arrive "
                    "out of order?)")
            sizes = (np.maximum(tr.cpu, tr.mem) if self.collapse
                     else np.stack([tr.cpu, tr.mem], axis=1))
            self.buf_slots = np.concatenate([self.buf_slots, slots])
            self.buf_sizes = np.concatenate([self.buf_sizes, sizes])
            self.buf_durs = np.concatenate(
                [self.buf_durs, np.asarray(tr.durations, np.int64)])
            self.last_slot = int(slots[-1])
            # every window whose end has provably passed is complete
            while self.last_slot >= self.win_lo + self.chunk_slots:
                self._pending.append(self._emit(self.chunk_slots))
        if self._pending:
            return self._pending.popleft()
        raise StopIteration


def _chunk_shape(streams: SchedStreams) -> tuple:
    """(ensemble?, G, A_max lanes, R) — the shape a stream's chunks must
    keep constant (the engine carry is built once, from the first)."""
    ensemble = streams.n.ndim == 2
    G = int(streams.n.shape[0]) if ensemble else 0
    R = streams.num_resources
    return (ensemble, G, int(streams.sizes.shape[streams.n.ndim]), R)


class _Stager:
    """Copies chunks to the run's device with the engines' dtypes.

    On a CUDA device each plane off the device goes through pinned host
    memory with ``non_blocking=True`` on a side stream; the compute stream
    waits on the copy's event, so the copy overlaps whatever the compute
    stream is still running, and the staged tensors are recorded on the
    compute stream for the caching allocator."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def __call__(self, chunk: SchedStreams) -> SchedStreams:
        planes = [None if x is None else torch.as_tensor(x).to(dtype=dt)
                  for x, dt in zip(chunk, _PLANE_DTYPES)]
        if not self.cuda:
            return SchedStreams(*(None if p is None else p.to(self.device)
                                  for p in planes))
        moved = []
        with torch.cuda.stream(self.side):
            for p in planes:
                if p is not None and p.device != self.device:
                    if p.device.type == "cpu":
                        pinned = torch.empty(p.shape, dtype=p.dtype,
                                             pin_memory=True)
                        p = pinned.copy_(p)
                    p = p.to(self.device, non_blocking=True)
                moved.append(p)
        copied = torch.cuda.Event()
        copied.record(self.side)
        self.compute.wait_event(copied)
        for p in moved:
            if p is not None:
                p.record_stream(self.compute)
        return SchedStreams(*moved)


def _done_event(device: torch.device):
    """An event recorded after a chunk's dispatch on the compute stream
    (None on the CPU, where dispatch returns with the work done)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def stream_policy(chunks: Iterable, *, policy: str = "bfjs",
                  engine: str = "scan",
                  checkpoint_dir: str | None = None,
                  resume: bool = False,
                  stop_after_chunks: int | None = None,
                  trajectory: str = "full",
                  supervisor: Supervisor | None = None,
                  audit: bool = False,
                  device=None,
                  **config) -> PolicyResult:
    """Run a (possibly infinite) iterator of ``SchedStreams`` chunks
    through a stateful scan engine with carried state on ``device``
    (default: the card; chunks are staged there) — see the module docstring
    for the pipeline, invariants and backpressure semantics.

    ``chunks`` yields contiguous time windows (``iter_stream_chunks``,
    ``stream_chunks_from_trace``, or any generator — windows may have
    different lengths, but must keep one arrival-lane width and, for
    ensembles, one G).  ``stop_after_chunks`` bounds how many chunks THIS
    call executes (the unbounded-generator escape hatch; the partial
    result is returned and, with ``checkpoint_dir=``, resumable).
    ``trajectory="tail"`` keeps only the newest chunk's per-slot planes
    (bounded memory; scalar counters stay whole-run exact).

    Bit-match contract: for any finite chunking of streams ``S``,
    ``stream_policy(iter_stream_chunks(S, c), policy=p)`` equals
    ``run_policy_streams(S, policy=p)`` bit-for-bit on every trajectory
    field, for every chunk size ``c``.

    ``supervisor=`` turns on the self-healing layer (retry/backoff,
    watchdogs, checkpoint rollback, poison-chunk quarantine — see
    ``core.engine.supervisor``); its counters land on the result's
    ``retries``/``quarantined``/``rollbacks`` fields.  Transient-fault
    recovery preserves the bit-match contract exactly; only a QUARANTINED
    chunk (deterministic poison, always counted, never silent) changes
    the trajectory vs. the unperturbed run.  ``audit=True`` checks the
    runtime conservation laws after every chunk (the check syncs the
    pipeline once per chunk) and raises a typed ``InvariantViolation``
    naming chunk and counter.
    """
    if policy not in _STATEFUL:
        raise ValueError(
            f"policy {policy!r} has no stateful scan engine; streaming "
            f"supports: {', '.join(sorted(_STATEFUL))}")
    if trajectory not in ("full", "tail"):
        raise ValueError(f"trajectory must be 'full' or 'tail', "
                         f"got {trajectory!r}")
    if engine == "reference":
        raise ValueError(
            'engine="reference" keeps host-side state and cannot stream; '
            'use engine="scan"')
    if engine == "cuda":
        raise ValueError(
            f'engine="cuda" cannot stream: the {policy} kernel keeps its '
            "simulation state in shared memory for one launch and cannot "
            "export/import the carry a streaming run threads between "
            'chunks; use engine="scan"')
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; streaming supports "
                         '"scan"')
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs checkpoint_dir=")
    device = resolve_device(device)
    stager = _Stager(device)

    sup = supervisor
    it = iter(chunks)

    def pull(index: int):
        """``next(it)`` — supervised: retried with backoff on transient
        (retryable) errors, each attempt under the staging watchdog.  A
        plain generator dies on the FIRST error it raises; detecting its
        premature ``StopIteration`` on retry turns silent stream
        truncation into a loud failure."""
        if sup is None:
            return next(it)
        failed = False

        def attempt():
            nonlocal failed
            try:
                return next(it)
            except StopIteration:
                # a resumable source may legitimately end right after a
                # recovered failure; a PLAIN generator cannot — it died
                if failed and isinstance(it, types.GeneratorType):
                    raise SupervisorError(
                        f"chunk source raised StopIteration while "
                        f"retrying chunk {index}: a plain generator dies "
                        "on its first error and cannot be retried — wrap "
                        "the source in a resumable reader (e.g. "
                        "core.trace.ResumableTraceReader)") from None
                raise
            except BaseException:
                failed = True
                raise

        return sup.call("chunk ingestion", attempt, chunk_index=index,
                        timeout=sup.stage_timeout)

    try:
        first = pull(0)
    except StopIteration:
        raise ValueError("stream_policy: the chunk iterator is empty") \
            from None

    ensemble, G, lanes, n_res = _chunk_shape(first)
    if policy == "bfjs-mr":
        from .bfjs_mr import _norm_capacity
        cap = config.get("capacity", 1.0)
        if not isinstance(cap, tuple):
            config["capacity"] = _norm_capacity(cap, max(n_res, 1))
    config.setdefault("A_max", lanes)
    apply_tuned(policy, "scan", config, max(n_res, 1), backend=device.type)
    config.pop("window", None)

    meta = {
        "policy": policy,
        "trajectory": trajectory,
        "ensemble": ensemble,
        "faulted": first.up is not None,
        "first_chunk_sha256": None,  # filled below (after lifting)
        "config": {k: repr(v) for k, v in sorted(config.items())},
    }

    def prepare(streams_chunk: SchedStreams, index: int) -> SchedStreams:
        """Host-side chunk staging: validate shape, lift bfjs-mr planes,
        copy to the device.  This is the work double-buffered against the
        previous chunk's device compute."""
        shape = _chunk_shape(streams_chunk)
        if shape != (ensemble, G, lanes, n_res):
            raise ValueError(
                f"chunk {index} changed shape mid-stream: (ensemble, G, "
                f"A_max, R) {shape} != first chunk's "
                f"{(ensemble, G, lanes, n_res)} — the engine carry keeps "
                "one shape for the life of the stream")
        staged = stager(streams_chunk)
        if policy == "bfjs-mr":
            from .bfjs_mr import _lift_sizes
            staged = _lift_sizes(staged)
        return staged

    base = _STATEFUL[policy]

    def runner(streams_chunk, st):
        return base(streams_chunk, st, config)

    def stage(chunk, index: int):
        """``prepare`` — supervised: retried transients, staging
        watchdog."""
        if sup is None:
            return prepare(chunk, index)
        return sup.call("chunk staging",
                        lambda: prepare(chunk, index),
                        chunk_index=index, timeout=sup.stage_timeout)

    def pull_staged(index: int):
        """Pull + stage source chunk ``index``.  Under supervision, a
        chunk that still fails after retries — or fails staging with a
        non-retryable error (e.g. a mid-stream shape change) — is
        quarantined (when a quarantine_dir exists) and the next source
        chunk tried.  Returns ``(staged, source_index)``; raises
        ``StopIteration`` on exhaustion.

        Retry contract: a supervised source must be IDEMPOTENT on failure
        — re-calling ``next()`` after an error re-attempts the SAME chunk
        (``core.trace.ResumableTraceReader`` provides this for CSV
        readers; a plain generator dies instead, which ``pull`` detects).
        A source may additionally expose ``skip()`` to advance past a
        poison chunk after quarantine; without it, a deterministically
        failing position keeps failing and the consecutive-quarantine
        limit aborts the stream (a broken source, not isolated poison)."""
        idx = index
        while True:
            try:
                raw = pull(idx)
            except (StopIteration, SupervisorTimeout):
                raise
            except Exception as e:
                if sup is None or not isinstance(e, sup.retry.retryable):
                    raise
                sup.quarantine(idx, e, policy=policy, config=config)
                skip = getattr(it, "skip", None)
                if skip is not None:
                    skip()
                idx += 1
                continue
            try:
                staged_chunk = stage(raw, idx)
            except (StopIteration, SupervisorTimeout):
                raise
            except Exception as e:
                if sup is None:
                    raise
                sup.quarantine(idx, e, streams_chunk=raw, policy=policy,
                               config=config)
                idx += 1
                continue
            if sup is not None:
                sup.mark_chunk_ok()
            return staged_chunk, idx

    def finish(result: PolicyResult, behind: int,
               stall_us: float) -> PolicyResult:
        extra = dict(chunks_behind=behind, host_stall_us=stall_us)
        if sup is not None:
            extra.update(retries=sup.retries, quarantined=sup.quarantined,
                         rollbacks=sup.rollbacks)
        return result._replace(**extra)

    staged = stage(first, 0)
    src = 0  # source index of the newest pulled chunk (quarantines count)
    meta["first_chunk_sha256"] = streams_fingerprint(staged)

    auditor = None
    if audit:
        auditor = make_auditor(policy=policy, config=config,
                               num_resources=max(n_res, 1))

        def arr_sum(s: SchedStreams):
            return s.n.sum(dim=-1, dtype=torch.int32)

        arr_cum = torch.zeros_like(arr_sum(staged))
        audit_zero = arr_cum

    start = 0
    state = None
    partial: PolicyResult | None = None
    if resume:
        if sup is not None:
            # rollback: walk back over corrupt boundaries (counted on
            # PolicyResult.rollbacks + CheckpointRollbackWarning) to the
            # newest checkpoint that still verifies
            latest, corrupt = ckpt.latest_valid_step(checkpoint_dir)
            sup.note_rollback(corrupt, checkpoint_dir)
        else:
            # unsupervised: a corrupt newest checkpoint surfaces as a
            # typed CheckpointCorruptError from read_manifest/_load_step
            latest = ckpt.latest_step(checkpoint_dir)
        if latest is not None:
            extra = ckpt.read_manifest(checkpoint_dir, latest)["extra"]
            stale = {k: (extra.get(k), v) for k, v in meta.items()
                     if extra.get(k) != v}
            if stale:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} belongs to a "
                    f"different stream; mismatched (found, expected): "
                    f"{stale}")
            state, partial = _load_step(checkpoint_dir, latest, policy,
                                        device)
            start = latest
            # skip the chunks already executed (the source re-iterates
            # deterministically — poison chunks quarantine again under
            # supervision, keeping the alignment; chunk 0's fingerprint
            # was checked above)
            if audit:
                arr_cum = arr_cum + arr_sum(staged)
            skipped = 1  # `first` is executed chunk 0
            while skipped < start:
                try:
                    done, src = pull_staged(src + 1)
                except StopIteration:
                    raise ValueError(
                        f"checkpoint says {start} chunks were executed "
                        f"but the iterator ran out after {skipped} — "
                        "resuming a DIFFERENT (shorter) stream?") from None
                if audit:
                    arr_cum = arr_cum + arr_sum(done)
                skipped += 1
            if start >= 1:
                try:
                    staged, src = pull_staged(src + 1)
                except StopIteration:
                    # stream fully executed already: return the checkpoint
                    return finish(partial, 0, 0.0)

    concat_axis = 1 if ensemble else 0
    dep_off = (lambda p: p.departed[..., -1:]) if ensemble \
        else (lambda p: p.departed[-1])

    def fold(part: PolicyResult | None, res: PolicyResult) -> PolicyResult:
        if trajectory == "full":
            return _append(part, res, axis=concat_axis)
        if part is None:
            return res
        return res._replace(departed=res.departed + dep_off(part))

    executed = 0
    chunks_behind = 0
    host_stall = 0.0
    inflight: deque = deque()  # (chunk index, completion event)
    i = start
    exhausted = False

    def drain_one() -> None:
        ck, done_ev = inflight.popleft()
        if done_ev is None:
            return
        if sup is not None and sup.compute_timeout is not None:
            sup.watch("device compute", done_ev.synchronize,
                      sup.compute_timeout, chunk_index=ck)
        else:
            done_ev.synchronize()

    while not exhausted:
        if stop_after_chunks is not None and executed >= stop_after_chunks:
            break
        # depth-2 pipeline: before dispatching chunk i, drain to at most
        # one incomplete dispatch; the time blocked here is device-bound
        # time — the healthy direction of backpressure.
        while len(inflight) > 1:
            t0 = time.perf_counter()
            drain_one()
            host_stall += time.perf_counter() - t0
        if audit:
            chunk_arr = arr_sum(staged)
        res, state = runner(staged, state)
        done_ev = _done_event(device)
        inflight.append((i, done_ev))
        # host-side work overlapped against the device: pull + stage the
        # NEXT chunk while this one computes
        try:
            staged, src = pull_staged(src + 1)
        except StopIteration:
            exhausted = True
        if done_ev is not None and not done_ev.query():
            pass  # device still busy: ingestion kept up
        elif not exhausted:
            chunks_behind += 1  # device idle before the host had chunk N+1
        if audit:
            dep_base = audit_zero if partial is None \
                else partial.departed[..., -1]
        partial = fold(partial, res)
        if audit:
            arr_cum = arr_cum + chunk_arr
            # the margins check syncs on this chunk's outputs — the price
            # of per-chunk auditing is one pipeline sync per chunk
            auditor(arr_cum, res, dep_base, chunk_index=i)
        executed += 1
        i += 1
        if checkpoint_dir is not None:
            # the save copies the carry to the host — synchronizes,
            # trading pipeline overlap for crash-safety at every boundary
            payload = _payload(state, partial)
            if sup is None:
                _save_step(checkpoint_dir, i, payload, meta)
            else:
                step = i
                sup.call(
                    "checkpoint write",
                    lambda: _save_step(checkpoint_dir, step, payload, meta),
                    chunk_index=step - 1)
    # drain the tail of the pipeline so a compute watchdog covers the
    # final dispatch too
    while inflight:
        drain_one()
    if partial is None:
        raise ValueError("nothing to run: stop_after_chunks=0 with no "
                         "checkpoint to return")
    return finish(partial, chunks_behind, host_stall * 1e6)
