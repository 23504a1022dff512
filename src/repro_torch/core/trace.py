"""Google-cluster-like trace synthesis and preprocessing (paper Section
VII.B): a copy of ``repro.core.trace`` for the port, host numpy by design.

The real 2011 Google trace is not shipped with this repository, so
``synthesize_google_like_trace`` generates a statistically faithful stand-in
reproducing the features the paper leans on:
  * hundreds of distinct discrete request values (Fig. 1): a lognormal body
    quantized to a fine grid plus a handful of heavy spikes at round values;
  * two resources (cpu, mem) with positive correlation; the paper's
    preprocessing maps each task to max(cpu, mem) — ``collapse_resources``;
  * diurnal arrival-rate modulation;
  * heavy-tailed service durations.

It draws from ``Generator(Philox(seed))``, so it gives the JAX package's
arrays bit for bit; the CSV readers accept, reject, count and word their
errors exactly as the JAX package's do.  A ``Trace`` goes straight into
``core.engine.streams_from_trace``.

``scale_arrivals`` implements the paper's "traffic scaling" 1/beta: arrival
times are multiplied by beta (larger 1/beta => more jobs per slot).
"""
from __future__ import annotations

import csv
import warnings
from dataclasses import dataclass

import numpy as np


@dataclass
class Trace:
    arrival_slots: np.ndarray   # int64, sorted
    cpu: np.ndarray             # float in (0,1]
    mem: np.ndarray             # float in (0,1]
    durations: np.ndarray       # int64 slots
    skipped: int = 0            # malformed rows dropped by the loader

    def __len__(self) -> int:
        return len(self.arrival_slots)


def synthesize_google_like_trace(n_tasks: int,
                                 horizon_slots: int,
                                 seed: int = 0,
                                 spike_values=(0.125, 0.25, 0.5),
                                 spike_prob: float = 0.3,
                                 mean_duration: float = 100.0) -> Trace:
    rng = np.random.Generator(np.random.Philox(seed))

    # --- arrivals: inhomogeneous Poisson via thinning of a diurnal rate ----
    base = n_tasks / horizon_slots
    t = np.arange(horizon_slots)
    day = max(horizon_slots / 1.5, 1.0)  # ~1.5 "days" in the window
    rate = base * (1.0 + 0.35 * np.sin(2 * np.pi * t / day) ** 2)
    rate *= n_tasks / max(rate.sum(), 1e-9)
    counts = rng.poisson(rate)
    arrival_slots = np.repeat(t, counts)

    n = len(arrival_slots)
    # --- sizes: lognormal body quantized to 1/1000 + discrete spikes -------
    body = np.exp(rng.normal(np.log(0.04), 0.9, size=n))
    body = np.clip(body, 1e-3, 1.0)
    body = np.ceil(body * 1000) / 1000  # => hundreds of distinct values
    spikes = rng.choice(spike_values, size=n)
    is_spike = rng.uniform(size=n) < spike_prob
    mem = np.where(is_spike, spikes, body)
    # cpu positively correlated with mem, with its own quantization
    cpu_noise = np.exp(rng.normal(0.0, 0.5, size=n))
    cpu = np.clip(mem * 0.6 * cpu_noise, 1e-3, 1.0)
    cpu = np.ceil(cpu * 400) / 400

    # --- durations: heavy-tailed lognormal, >= 1 slot ----------------------
    dur = np.exp(rng.normal(np.log(mean_duration * 0.5), 1.0, size=n))
    dur = np.clip(dur, 1, mean_duration * 50).astype(np.int64)

    return Trace(arrival_slots.astype(np.int64), cpu, mem, dur)


#: Accepted spellings per column, lowercase (Google-2019 / Alibaba style).
#: A job-id column may be present (it is ignored — arrival order is the
#: identity the engines use) but is not required.
_COLUMN_ALIASES = {
    "submit_time": ("submit_time", "submit", "time", "arrival_time",
                    "start_time"),
    "cpu": ("cpu", "cpu_request", "request_cpu", "plan_cpu", "cpus"),
    "mem": ("mem", "memory", "mem_request", "request_mem", "plan_mem"),
    "duration": ("duration", "runtime", "duration_slots", "run_time"),
}


def _resolve_columns(path, names: list[str], aliases: dict) -> dict:
    """Map canonical field names to header indices, or raise naming every
    accepted spelling (shared by the one-shot and streaming readers)."""
    cols = {}
    for field, spellings in aliases.items():
        for a in spellings:
            if a in names:
                cols[field] = names.index(a)
                break
        else:
            raise ValueError(
                f"{path}: no column for {field!r} (looked for "
                f"{', '.join(spellings)}; header: {', '.join(names)})")
    return cols


class _TraceRowParser:
    """The row-parsing core shared by ``load_trace_csv`` (one-shot) and
    ``iter_trace_csv`` (streaming) — one implementation of field parsing,
    domain checks and malformed-row accounting, so both readers accept and
    reject EXACTLY the same rows.

    ``parse(ln, rec)`` returns ``(submit, cpu, mem, duration)`` for a good
    row, ``None`` for a blank or malformed one.  Malformed rows are counted
    in ``skipped`` (``strict=False``) or raise ``ValueError`` naming the
    file and 1-based row — plus the chunk index when ``chunk_of`` is set by
    the streaming reader, so a bad row deep in a multi-GB file is located
    as ``file:row (chunk N)``.
    """

    def __init__(self, path, cols: dict, *, strict: bool = False,
                 chunk_of=None):
        self.path = path
        self.cols = cols
        self.strict = strict
        self.skipped = 0
        self.prev_s = -np.inf
        #: Callable returning the CURRENT chunk index (streaming reader
        #: only) — late-bound so the parser needn't know chunk boundaries.
        self.chunk_of = chunk_of

    def _bad(self, ln: int, why: str, rec) -> None:
        if self.strict:
            where = "" if self.chunk_of is None \
                else f" (chunk {self.chunk_of()})"
            raise ValueError(f"{self.path}:{ln}{where}: {why}: {rec!r}")
        self.skipped += 1

    def parse(self, ln: int, rec) -> tuple | None:
        if not rec or not "".join(rec).strip():
            return None
        cols = self.cols
        try:
            s = float(rec[cols["submit_time"]])
            c = float(rec[cols["cpu"]])
            m = float(rec[cols["mem"]])
            d = float(rec[cols["duration"]])
        except (ValueError, IndexError):
            self._bad(ln, "bad row (unparseable field)", rec)
            return None
        if not all(np.isfinite(v) for v in (s, c, m, d)):
            self._bad(ln, "bad row (non-finite field)", rec)
            return None
        if c < 0 or m < 0 or (c <= 0 and m <= 0):
            self._bad(ln, "bad row (non-positive resource request)", rec)
            return None
        if d <= 0:
            self._bad(ln, "bad row (non-positive duration)", rec)
            return None
        if s < self.prev_s:
            self._bad(ln, "bad row (non-monotone submit time "
                          f"{s:g} after {self.prev_s:g})", rec)
            return None
        self.prev_s = s
        return s, c, m, d


def load_trace_csv(path, *, slot_seconds: float = 1.0,
                   normalize: bool = True, strict: bool = False) -> Trace:
    """Load a Google-2019 / Alibaba-style CSV into a :class:`Trace`.

    Expects a header row naming (in any order, any of the usual spellings)
    submit time, cpu, mem and duration columns — see ``_COLUMN_ALIASES``;
    a job-id column may be present but is ignored (arrival order is the
    identity the engines use).  Submit times and durations are in seconds
    and land on the slot grid via ``slot_seconds`` (floor for arrivals,
    ceil with a 1-slot minimum for durations — a job never serves zero
    slots).  Arrival slots are re-based so the earliest job arrives at
    slot 0, and jobs are stably sorted (submit order preserved within a
    slot).

    ``normalize=True`` (default) rescales cpu/mem to machine fractions by
    their column maxima when any value exceeds 1 (public traces report
    absolute core counts / bytes); values are then clipped into (0, 1] —
    the engines' job-size domain.  ``normalize=False`` takes the values as
    already-normalized fractions and REJECTS anything outside (0, 1]
    instead of silently saturating it.

    Malformed rows — unparseable fields, NaN/inf values, negative cpu or
    mem, non-positive (cpu AND mem) or duration, and submit times that go
    BACKWARDS relative to the previous accepted row — are never consumed
    silently: under ``strict=False`` (default) each is skipped and
    counted (``Trace.skipped``, plus one summary warning); under
    ``strict=True`` the first one raises ``ValueError`` naming the file
    and 1-based row number.

    Returns the trace sorted by arrival slot — directly consumable by
    ``streams_from_trace(trace, collapse=False)`` (uncollapsed (cpu, mem)
    for ``policy="bfjs-mr"``) or with the paper's max-collapse.
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty trace file") from None
        names = [h.strip().lower() for h in header]
        parser = _TraceRowParser(path, _resolve_columns(path, names,
                                                        _COLUMN_ALIASES),
                                 strict=strict)
        submit, cpu, mem, dur = [], [], [], []
        for ln, rec in enumerate(reader, start=2):
            parsed = parser.parse(ln, rec)
            if parsed is None:
                continue
            s, c, m, d = parsed
            submit.append(s)
            cpu.append(c)
            mem.append(m)
            dur.append(d)
    skipped = parser.skipped
    if not submit:
        detail = f" ({skipped} malformed row(s) skipped)" if skipped else ""
        raise ValueError(f"{path}: no usable rows{detail}")
    if skipped:
        warnings.warn(
            f"{path}: skipped {skipped} malformed row(s) — pass "
            "strict=True to fail on the first instead", stacklevel=2)

    submit = np.asarray(submit)
    cpu = np.asarray(cpu)
    mem = np.asarray(mem)
    dur = np.asarray(dur)
    if normalize:
        if cpu.max() > 1.0:
            cpu = cpu / cpu.max()
        if mem.max() > 1.0:
            mem = mem / mem.max()
        cpu = np.clip(cpu, 1e-6, 1.0)
        mem = np.clip(mem, 1e-6, 1.0)
    elif cpu.max() > 1.0 or mem.max() > 1.0:
        raise ValueError(
            f"{path}: cpu/mem values exceed 1 (max cpu={cpu.max():g}, "
            f"mem={mem.max():g}) but normalize=False — these look like "
            "absolute units; pass normalize=True or rescale first")
    else:
        cpu = np.maximum(cpu, 1e-6)
        mem = np.maximum(mem, 1e-6)
    slots = np.floor((submit - submit.min()) / slot_seconds).astype(np.int64)
    dur_slots = np.maximum(np.ceil(dur / slot_seconds), 1).astype(np.int64)
    order = np.argsort(slots, kind="stable")
    return Trace(slots[order], cpu[order], mem[order], dur_slots[order],
                 skipped=skipped)


def scan_trace_maxima(path) -> tuple[float, float]:
    """One constant-memory pass over a trace CSV returning
    ``(cpu_max, mem_max)`` over its parseable rows.

    A streaming reader cannot normalize by column maxima the way
    ``load_trace_csv(normalize=True)`` does — it never holds the whole
    column.  The two-pass recipe for a file in absolute units::

        cpu_cap, mem_cap = scan_trace_maxima(path)
        chunks = iter_trace_csv(path, chunk_rows=100_000,
                                cpu_capacity=cpu_cap, mem_capacity=mem_cap)

    reproduces the one-shot normalization exactly.  Malformed rows are
    skipped silently here (they are accounted for by the reader proper).
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty trace file") from None
        names = [h.strip().lower() for h in header]
        parser = _TraceRowParser(path, _resolve_columns(path, names,
                                                        _COLUMN_ALIASES))
        cpu_max = mem_max = 0.0
        for ln, rec in enumerate(reader, start=2):
            parsed = parser.parse(ln, rec)
            if parsed is None:
                continue
            _, c, m, _ = parsed
            cpu_max = max(cpu_max, c)
            mem_max = max(mem_max, m)
    if cpu_max == 0.0 and mem_max == 0.0:
        raise ValueError(f"{path}: no usable rows")
    return cpu_max, mem_max


def iter_trace_csv(path, *, chunk_rows: int,
                   slot_seconds: float = 1.0,
                   normalize: bool = True,
                   strict: bool = False,
                   cpu_capacity: float | None = None,
                   mem_capacity: float | None = None,
                   machine_events: "MachineEvents | None" = None):
    """Stream a trace CSV as :class:`Trace` chunks of ``<= chunk_rows``
    accepted rows each — constant host memory for multi-GB files.

    Column handling, row validation and malformed-row accounting are the
    SAME code as :func:`load_trace_csv` (``_TraceRowParser``): both
    readers accept and reject exactly the same rows.  Differences forced
    by streaming:

    * **Normalization** cannot use global column maxima (never all in
      memory).  Pass explicit ``cpu_capacity=``/``mem_capacity=``
      divisors — e.g. from :func:`scan_trace_maxima` (two-pass recipe,
      bit-identical to one-shot ``normalize=True``) or from a
      ``machine_events=`` fleet (per-machine capacity normalization:
      the divisor is the fleet's max capacity, so a full request of the
      biggest machine maps to 1.0).  With ``normalize=True`` and no
      divisors, values are taken as machine fractions already and any
      value > 1 raises (rather than mis-scaling a chunk by its local
      max, which would silently break cross-chunk comparability).
    * **Slot re-basing** uses the FIRST accepted row's submit time as
      t0 (the one-shot reader uses the global min — identical for any
      monotone-submit-time file, which validation enforces up to
      skipped rows).
    * ``strict=True`` errors name ``file:row (chunk N)`` so a bad row
      deep in a huge file is located without re-reading it.

    Each yielded chunk is a :class:`Trace` (sorted, slot-rebased to the
    SHARED t0, per-chunk ``skipped`` count).  Chunks never split a slot's
    jobs ACROSS slot boundaries — rows land in a chunk purely by count,
    so a slot's arrivals may span two chunks; downstream re-bucketing
    (``stream_chunks_from_trace``) handles that.  A summary warning on
    exhaustion reports the total skipped (mirroring ``load_trace_csv``).
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if machine_events is not None:
        if cpu_capacity is not None or mem_capacity is not None:
            raise ValueError(
                "pass machine_events= OR explicit cpu_capacity/"
                "mem_capacity, not both")
        cpu_capacity = float(machine_events.cpu_capacity.max())
        mem_capacity = float(machine_events.mem_capacity.max())
    if (cpu_capacity is None) != (mem_capacity is None):
        raise ValueError(
            "cpu_capacity and mem_capacity must be passed together")
    if cpu_capacity is not None and (cpu_capacity <= 0 or mem_capacity <= 0):
        raise ValueError(
            f"capacities must be positive, got cpu_capacity={cpu_capacity!r} "
            f"mem_capacity={mem_capacity!r}")

    chunk_idx = 0
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty trace file") from None
        names = [h.strip().lower() for h in header]
        parser = _TraceRowParser(path, _resolve_columns(path, names,
                                                        _COLUMN_ALIASES),
                                 strict=strict,
                                 chunk_of=lambda: chunk_idx)
        t0 = None
        skipped_at_chunk_start = 0
        submit, cpu, mem, dur = [], [], [], []

        def emit() -> Trace:
            nonlocal submit, cpu, mem, dur, skipped_at_chunk_start
            s = np.asarray(submit)
            c = np.asarray(cpu)
            m = np.asarray(mem)
            d = np.asarray(dur)
            if cpu_capacity is not None:
                c = c / cpu_capacity
                m = m / mem_capacity
                c = np.clip(c, 1e-6, 1.0)
                m = np.clip(m, 1e-6, 1.0)
            elif normalize:
                if c.max() > 1.0 or m.max() > 1.0:
                    raise ValueError(
                        f"{path}: cpu/mem values exceed 1 (max "
                        f"cpu={c.max():g}, mem={m.max():g}) but no "
                        "capacities were given — a streaming reader cannot "
                        "normalize by global column maxima; pass "
                        "cpu_capacity=/mem_capacity= (e.g. from "
                        "scan_trace_maxima) or machine_events=")
                c = np.clip(c, 1e-6, 1.0)
                m = np.clip(m, 1e-6, 1.0)
            elif c.max() > 1.0 or m.max() > 1.0:
                raise ValueError(
                    f"{path}: cpu/mem values exceed 1 (max cpu={c.max():g}, "
                    f"mem={m.max():g}) but normalize=False — these look "
                    "like absolute units; pass capacities or rescale first")
            else:
                c = np.maximum(c, 1e-6)
                m = np.maximum(m, 1e-6)
            slots = np.floor((s - t0) / slot_seconds).astype(np.int64)
            d_slots = np.maximum(np.ceil(d / slot_seconds), 1).astype(np.int64)
            order = np.argsort(slots, kind="stable")
            chunk_skipped = parser.skipped - skipped_at_chunk_start
            skipped_at_chunk_start = parser.skipped
            submit, cpu, mem, dur = [], [], [], []
            return Trace(slots[order], c[order], m[order], d_slots[order],
                         skipped=chunk_skipped)

        for ln, rec in enumerate(reader, start=2):
            parsed = parser.parse(ln, rec)
            if parsed is None:
                continue
            s, c, m, d = parsed
            if t0 is None:
                t0 = s
            submit.append(s)
            cpu.append(c)
            mem.append(m)
            dur.append(d)
            if len(submit) >= chunk_rows:
                yield emit()
                chunk_idx += 1
        if submit:
            yield emit()
    if parser.skipped:
        warnings.warn(
            f"{path}: skipped {parser.skipped} malformed row(s) — pass "
            "strict=True to fail on the first instead", stacklevel=2)
    if t0 is None:
        detail = (f" ({parser.skipped} malformed row(s) skipped)"
                  if parser.skipped else "")
        raise ValueError(f"{path}: no usable rows{detail}")


class ResumableTraceReader:
    """Re-openable :func:`iter_trace_csv` for supervised streaming.

    A plain generator dies on the first exception it raises — a retried
    ``next()`` then yields ``StopIteration``, which reads as end-of-stream
    and would silently truncate the trace.  This wrapper makes the reader
    actually retryable: after an attempt fails, the NEXT ``next()`` call
    re-opens the file from scratch and fast-forwards past the chunks
    already emitted, so a caller's retry-with-backoff
    (``core.engine.supervisor``) sees each chunk until it
    either parses or exhausts its retries.  ``reopens`` counts the recoveries.

    Fast-forwarding re-parses the file head — O(file) per recovery, the
    price of supporting plain (non-seekable-safe) CSV sources.  Determinism
    holds because :func:`iter_trace_csv` is a pure function of the file
    contents: the re-read emits bit-identical chunks.

    ``_open`` is the injection seam the chaos harness uses to interpose
    flaky transports; production code never overrides it.
    """

    def __init__(self, path, **kwargs):
        self.path = path
        self.kwargs = kwargs
        self.reopens = 0
        self._emitted = 0
        self._gen = None

    def _open(self):
        return iter_trace_csv(self.path, **self.kwargs)

    def __iter__(self):
        return self

    def __next__(self) -> Trace:
        if self._gen is None:
            gen = self._open()
            if self._emitted:
                self.reopens += 1
                with warnings.catch_warnings():
                    # the skipped-rows summary already fired on the first
                    # pass; don't duplicate it while fast-forwarding
                    warnings.simplefilter("ignore")
                    for k in range(self._emitted):
                        try:
                            next(gen)
                        except StopIteration:
                            raise OSError(
                                f"{self.path}: shrank between reopens — "
                                f"only {k} chunk(s) left of the "
                                f"{self._emitted} already emitted; the "
                                "file changed underneath the stream"
                            ) from None
            self._gen = gen
        try:
            out = next(self._gen)
        except StopIteration:
            raise
        except BaseException:
            # drop the dead generator; the retry re-opens + fast-forwards
            self._gen = None
            raise
        self._emitted += 1
        return out


# ---------------------------------------------------------------------------
# Google-2019 machine-events schema adapter
# ---------------------------------------------------------------------------

#: Google-2019 machine-events type codes.
MACHINE_ADD, MACHINE_REMOVE, MACHINE_UPDATE = 1, 2, 3

_MACHINE_COLUMN_ALIASES = {
    "time": ("time", "timestamp", "event_time"),
    "machine_id": ("machine_id", "machineid", "machine"),
    "type": ("type", "event_type", "event"),
    "cpu": ("cpus", "cpu", "cpu_capacity", "capacity_cpu"),
    "mem": ("memory", "mem", "mem_capacity", "capacity_memory"),
}


@dataclass
class MachineEvents:
    """Fleet capacities + up/down event schedule from a Google-2019
    machine-events table.

    ``machine_ids`` maps server index -> original machine id (index order
    = first-appearance order, the identity the engines' ``(T, L)`` fault
    plane uses).  ``cpu_capacity``/``mem_capacity`` are each machine's
    ABSOLUTE capacity (max over its ADD/UPDATE events) — their fleet
    maxima are the per-machine normalization divisors
    ``iter_trace_csv(machine_events=...)`` uses.  ``events`` is a list of
    ``(slot, server_idx, up)`` suitable for
    ``core.engine.fault_plane_from_events``.
    """
    machine_ids: np.ndarray     # (L,) int64, first-appearance order
    cpu_capacity: np.ndarray    # (L,) float, absolute units
    mem_capacity: np.ndarray    # (L,) float, absolute units
    events: list                # [(slot, server_idx, up), ...] time-sorted

    @property
    def num_servers(self) -> int:
        return len(self.machine_ids)


def load_machine_events_csv(path, *, slot_seconds: float = 1.0,
                            strict: bool = False) -> MachineEvents:
    """Load a Google-2019 machine-events CSV (time, machine_id, type
    ADD=1/REMOVE=2/UPDATE=3, cpus, memory — usual alias spellings).

    ADD/UPDATE mark a machine up (and refresh its capacity); REMOVE marks
    it down.  Slots are re-based to the earliest event.  Malformed rows
    follow the trace-reader contract: skip-and-count by default,
    ``strict=True`` raises naming file:row.
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty machine-events file") from None
        names = [h.strip().lower() for h in header]
        cols = _resolve_columns(path, names, _MACHINE_COLUMN_ALIASES)
        skipped = 0

        def bad(ln, why, rec):
            nonlocal skipped
            if strict:
                raise ValueError(f"{path}:{ln}: {why}: {rec!r}")
            skipped += 1

        ids: list = []           # first-appearance order
        index: dict = {}
        cpu_cap: list = []
        mem_cap: list = []
        raw_events = []          # (time, server_idx, up)
        for ln, rec in enumerate(reader, start=2):
            if not rec or not "".join(rec).strip():
                continue
            try:
                t = float(rec[cols["time"]])
                mid = int(float(rec[cols["machine_id"]]))
                etype = int(float(rec[cols["type"]]))
            except (ValueError, IndexError):
                bad(ln, "bad row (unparseable field)", rec)
                continue
            if etype not in (MACHINE_ADD, MACHINE_REMOVE, MACHINE_UPDATE):
                bad(ln, f"bad row (unknown event type {etype})", rec)
                continue
            up = etype != MACHINE_REMOVE
            c = m = 0.0
            if up:
                try:
                    c = float(rec[cols["cpu"]])
                    m = float(rec[cols["mem"]])
                except (ValueError, IndexError):
                    bad(ln, "bad row (unparseable capacity)", rec)
                    continue
                if not (np.isfinite(c) and np.isfinite(m)) \
                        or c <= 0 or m <= 0:
                    bad(ln, "bad row (non-positive capacity)", rec)
                    continue
            if mid not in index:
                index[mid] = len(ids)
                ids.append(mid)
                cpu_cap.append(0.0)
                mem_cap.append(0.0)
            si = index[mid]
            if up:
                cpu_cap[si] = max(cpu_cap[si], c)
                mem_cap[si] = max(mem_cap[si], m)
            raw_events.append((t, si, up))
    if not raw_events:
        detail = f" ({skipped} malformed row(s) skipped)" if skipped else ""
        raise ValueError(f"{path}: no usable rows{detail}")
    if skipped:
        warnings.warn(
            f"{path}: skipped {skipped} malformed row(s) — pass "
            "strict=True to fail on the first instead", stacklevel=2)
    never_up = [ids[i] for i in range(len(ids)) if cpu_cap[i] <= 0]
    if never_up:
        raise ValueError(
            f"{path}: machine(s) {never_up} only ever REMOVEd — no "
            "capacity to normalize against")
    raw_events.sort(key=lambda e: e[0])
    t0 = raw_events[0][0]
    events = [(int(np.floor((t - t0) / slot_seconds)), si, up)
              for t, si, up in raw_events]
    return MachineEvents(
        machine_ids=np.asarray(ids, dtype=np.int64),
        cpu_capacity=np.asarray(cpu_cap),
        mem_capacity=np.asarray(mem_cap),
        events=events,
    )


def collapse_resources(trace: Trace) -> np.ndarray:
    """Paper preprocessing: single resource = max(cpu, mem)."""
    return np.maximum(trace.cpu, trace.mem)


def scale_arrivals(trace: Trace, traffic_scaling: float) -> Trace:
    """Traffic scaling 1/beta: multiply arrival times by beta = 1/scaling."""
    beta = 1.0 / traffic_scaling
    return Trace(
        arrival_slots=np.floor(trace.arrival_slots * beta).astype(np.int64),
        cpu=trace.cpu,
        mem=trace.mem,
        durations=trace.durations,
    )


def empirical_size_stats(sizes: np.ndarray) -> dict:
    """Fig. 1-style statistics: number of distinct discrete requirements."""
    vals, counts = np.unique(np.round(sizes, 6), return_counts=True)
    return {
        "distinct_values": int(len(vals)),
        "mean": float(sizes.mean()),
        "p50": float(np.quantile(sizes, 0.5)),
        "p99": float(np.quantile(sizes, 0.99)),
        "max": float(sizes.max()),
    }
