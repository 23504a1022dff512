"""Crash-safe chunked policy sweeps over the scan engines (torch port of
``repro.core.engine.chunked``).

Long Monte-Carlo horizons run as a sequence of T-chunks: each chunk is one
scan-engine call over ``chunk`` slots whose COMPLETE carry (the policy's
State NamedTuple: server planes, queue planes, retry/seq planes, counters,
``up_last``) is persisted with :mod:`repro_torch.checkpoint.ckpt` at every
chunk boundary — atomic tmp-then-rename directories, so a SIGKILL at ANY
point leaves either the previous or the next complete checkpoint on disk,
never a torn one.  ``resume=True`` restores the newest boundary and
continues; because the carry is the engine's entire state, an
interrupted-and-resumed sweep is BIT-IDENTICAL to a straight-through run.

Checkpoints use the JAX package's layout and manifest: ``state/<i>`` in
carry order, ``partial/<field>`` by ``PolicyResult`` field, and a
``streams_sha256`` fingerprint hashed over the same bytes, so a sweep
checkpointed by either package resumes in the other.  The manifest pins
policy, horizon, chunk, the engine config and the streams; it names no
device, so a sweep checkpointed on one device resumes on another.

Only the scan engine chunks (``api.run_policy_streams`` refuses the
others): the reference oracles keep host-side state, and the CUDA kernels
keep a member's state in shared memory for one launch.  The port's scan
engines batch over a leading ensemble axis G natively, so ensemble
streams chunk with no extra mapping.

Per-chunk ``departed`` restarts at zero (it is an output, not carry); the
chunk loop re-offsets each chunk by the previous cumulative total.  The
scalar counters accumulate inside the carry, so the final chunk's values
are already whole-horizon totals.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Callable

import torch

from ...checkpoint import ckpt
from .streams import PolicyResult, SchedStreams


def _bfjs_stateful(streams, state, config):
    from .bfjs import run_bfjs_streams
    return run_bfjs_streams(streams, state=state, return_state=True,
                            **config)


def _vqs_stateful(streams, state, config):
    from .vqs import run_vqs_streams
    return run_vqs_streams(streams, state=state, return_state=True,
                           **config)


def _bfjs_mr_stateful(streams, state, config):
    from .bfjs_mr import run_bfjs_mr_streams
    return run_bfjs_mr_streams(streams, state=state, return_state=True,
                               **config)


def _vqs_bf_stateful(streams, state, config):
    from .vqs_bf import run_vqs_bf_streams
    return run_vqs_bf_streams(streams, state=state, return_state=True,
                              **config)


_STATEFUL: dict[str, Callable] = {
    "bfjs": _bfjs_stateful,
    "vqs": _vqs_stateful,
    "bfjs-mr": _bfjs_mr_stateful,
    "vqs-bf": _vqs_bf_stateful,
}


def streams_fingerprint(streams: SchedStreams) -> str:
    """SHA-256 over every stream plane (dtype, shape and bytes) — the
    resume guard that a checkpoint only ever continues its own sweep.  The
    dtype and shape are numpy's reprs and the bytes C-ordered, exactly what
    the JAX package hashes, so both give one digest for one set of
    streams."""
    h = hashlib.sha256()
    for name, arr in zip(streams._fields, tuple(streams)):
        if arr is None:
            h.update(f"{name}:none;".encode())
        else:
            a = ckpt._to_numpy(arr)
            h.update(f"{name}:{a.dtype}:{a.shape};".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _slice_streams(streams: SchedStreams, lo: int, hi: int,
                   ensemble: bool = False) -> SchedStreams:
    sl = (slice(None), slice(lo, hi)) if ensemble else slice(lo, hi)
    return streams._replace(
        n=streams.n[sl], sizes=streams.sizes[sl], durs=streams.durs[sl],
        up=None if streams.up is None else streams.up[sl])


def _append(partial: PolicyResult | None, res: PolicyResult,
            axis: int = 0) -> PolicyResult:
    if partial is None:
        return res
    dep_off = partial.departed[..., -1:] if axis else partial.departed[-1]
    return PolicyResult(
        torch.cat([partial.queue_len, res.queue_len], dim=axis),
        torch.cat([partial.occupancy, res.occupancy], dim=axis),
        torch.cat([partial.departed, res.departed + dep_off], dim=axis),
        res.dropped, res.truncated, res.preempted, res.requeued, res.lost)


def _save_step(checkpoint_dir: str, step: int, payload: Any,
               extra: dict) -> None:
    """One chunk-boundary save (factored out so crash tests can intercept
    the exact boundary)."""
    ckpt.save(checkpoint_dir, step, payload, extra=extra)


def _payload(state, partial: PolicyResult) -> dict:
    """The boundary checkpoint's tree: the carry as a plain tuple, so its
    leaves are keyed ``state/<i>`` as the JAX package keys its anonymous
    scan carry."""
    return {"state": tuple(state), "partial": partial}


def _state_from_arrays(policy: str, carry: tuple, device):
    from ... import convert
    build = {"bfjs": convert.bfjs_state_from_numpy,
             "vqs": convert.vqs_state_from_numpy,
             "vqs-bf": convert.vqs_bf_state_from_numpy,
             "bfjs-mr": convert.bfjs_mr_state_from_numpy}[policy]
    return build(carry, device=device)


def _load_step(checkpoint_dir: str, step: int, policy: str, device
               ) -> tuple[tuple, PolicyResult]:
    """Rebuild (scan state, partial result) from a boundary checkpoint on
    ``device`` (the streams' device).

    The state is restored by npz key layout — ``state/<i>`` leaves in
    index order, rebuilt into ``policy``'s State NamedTuple with the
    engine's dtypes — and ``partial/<field>`` leaves by ``PolicyResult``
    field name.

    Reads go through ``ckpt.load_arrays`` — checksum-verified, so a
    truncated or garbled file raises a typed
    :class:`~repro_torch.checkpoint.ckpt.CheckpointCorruptError` naming the
    path; supervised streaming catches exactly that type to roll back to
    the last good boundary.
    """
    path = os.path.join(checkpoint_dir, f"step_{step:08d}", "arrays.npz")
    data = ckpt.load_arrays(checkpoint_dir, step)
    idxs = sorted(int(k.split("/", 1)[1]) for k in data
                  if k.startswith("state/"))
    if idxs != list(range(len(idxs))) or not idxs:
        raise ckpt.CheckpointCorruptError(
            path, f"state indices {idxs} are not a dense 0..N range")
    try:
        state = _state_from_arrays(
            policy, tuple(data[f"state/{i}"] for i in idxs), device)
    except ValueError as e:
        raise ckpt.CheckpointCorruptError(path, f"{policy} carry: {e}") \
            from e
    # Optional fields (the streaming and supervision counters) are None
    # leaves — left out at save time, so absent from the npz.
    partial = PolicyResult(*(
        torch.from_numpy(data[f"partial/{f}"]).to(device)
        if f"partial/{f}" in data else None
        for f in PolicyResult._fields))
    return state, partial


def run_chunked(streams: SchedStreams, *, policy: str = "bfjs",
                chunk: int, checkpoint_dir: str | None = None,
                resume: bool = False,
                stop_after_chunks: int | None = None,
                **config) -> PolicyResult:
    """Run a scan-engine sweep in crash-safe chunks (see module docstring),
    on the streams' device.

    ``stop_after_chunks`` ends the run early after that many chunks have
    been EXECUTED this call (checkpoints included) — the hook crash tests
    use to stop at an arbitrary boundary; the partial result is returned.
    Streams with a leading ensemble axis (``n.ndim == 2``) run every
    member in each chunk's one batched call.
    """
    if policy not in _STATEFUL:
        raise ValueError(
            f"policy {policy!r} has no stateful scan engine; chunked "
            f"sweeps support: {', '.join(sorted(_STATEFUL))}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs checkpoint_dir=")
    # never pinned by the manifest: the streams' device runs the sweep,
    # and the scan engine takes neither a kernel gate nor a window
    for key in ("device", "strict", "window"):
        config.pop(key, None)
    ensemble = streams.n.ndim == 2
    if policy == "bfjs-mr":
        from .bfjs_mr import _lift_sizes, _norm_capacity
        streams = _lift_sizes(streams)
        cap = config.get("capacity", 1.0)
        if not isinstance(cap, tuple):
            config["capacity"] = _norm_capacity(
                cap, int(streams.sizes.shape[-1]))
    config.setdefault("A_max", int(streams.sizes.shape[streams.n.ndim]))
    T = int(streams.n.shape[-1])
    bounds = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
    meta = {
        "policy": policy,
        "horizon": T,
        "chunk": int(chunk),
        "n_chunks": len(bounds),
        "faulted": streams.up is not None,
        "streams_sha256": streams_fingerprint(streams),
        "config": {k: repr(v) for k, v in sorted(config.items())},
    }

    start = 0
    state = None
    partial: PolicyResult | None = None
    if resume:
        latest = ckpt.latest_step(checkpoint_dir)
        if latest is not None:
            extra = ckpt.read_manifest(checkpoint_dir, latest)["extra"]
            stale = {k: (extra.get(k), v) for k, v in meta.items()
                     if extra.get(k) != v}
            if stale:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir!r} belongs to a "
                    f"different sweep; mismatched (found, expected): "
                    f"{stale}")
            if latest > len(bounds):
                raise ValueError(
                    f"checkpoint step {latest} exceeds the sweep's "
                    f"{len(bounds)} chunks")
            state, partial = _load_step(checkpoint_dir, latest, policy,
                                        streams.n.device)
            start = latest

    runner = _STATEFUL[policy]
    executed = 0
    for i in range(start, len(bounds)):
        if stop_after_chunks is not None and executed >= stop_after_chunks:
            break
        lo, hi = bounds[i]
        res, state = runner(_slice_streams(streams, lo, hi, ensemble),
                            state, config)
        partial = _append(partial, res, axis=1 if ensemble else 0)
        executed += 1
        if checkpoint_dir is not None:
            _save_step(checkpoint_dir, i + 1, _payload(state, partial),
                       meta)
    if partial is None:
        raise ValueError("nothing to run: empty horizon or "
                         "stop_after_chunks=0 with no checkpoint")
    return partial
