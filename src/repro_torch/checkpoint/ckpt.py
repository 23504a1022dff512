"""Checkpointing: atomic, async-capable, self-verifying (torch port of
``repro.checkpoint.ckpt``).

Layout:  <dir>/step_<N:08d>/arrays.npz  + manifest.json — the JAX
package's, byte for byte in structure, so either package reads the
other's checkpoints:

  * arrays are stored host-side as numpy, keyed by their path in the saved
    tree joined with ``/`` (``state/0``, ``partial/queue_len``): dict keys
    (sorted, as JAX flattens them), NamedTuple field names, tuple and list
    indices; ``None`` leaves are left out;
  * a bfloat16 leaf (numpy has no such type) is stored as its bits, a
    ``uint16`` array, and named in the manifest's ``dtypes``; restore
    views it back.  JAX writes such a leaf as numpy's ``|V2`` and cannot
    restore it (a difference by design: PERF.md, reference quirks);
  * writes go to ``step_<N>.tmp`` then rename (atomic on POSIX);
  * :class:`AsyncCheckpointer` copies to the host on the caller thread and
    writes in a background thread;
  * every save records a SHA-256 of ``arrays.npz`` in its manifest
    (``arrays_sha256``); loads verify it, so a truncated or bit-rotted
    checkpoint surfaces as a typed :class:`CheckpointCorruptError` naming
    the offending path — never a raw zip/numpy error — and
    :func:`latest_valid_step` finds the newest checkpoint that still
    verifies (the rollback primitive of supervised streaming).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint on disk is truncated, garbled, or fails its checksum.

    Always names the offending file; raised instead of whatever raw
    ``zipfile``/``numpy`` error the damage would otherwise surface as, so
    callers can catch ONE type to trigger rollback."""

    def __init__(self, path: str, why: str):
        self.path = path
        self.why = why
        super().__init__(f"corrupt checkpoint at {path}: {why}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _map_with_path(fn: Callable[[str, Any], Any], tree, path=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, where
    ``key`` is the leaf's path joined with :data:`SEP`.  Containers are
    dicts (sorted keys), NamedTuples (field names), tuples and lists
    (indices); ``None`` is an empty subtree; anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(SEP.join(path), tree)


#: Tensor dtypes numpy cannot hold, stored as the bits of an integer of
#: their width and named in the manifest's ``dtypes``.
_AS_BITS = {torch.bfloat16: (torch.int16, np.uint16)}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stored(x) -> np.ndarray:
    """The leaf as it is stored: a dtype of :data:`_AS_BITS` as its bits."""
    if isinstance(x, torch.Tensor) and x.dtype in _AS_BITS:
        signed, bits = _AS_BITS[x.dtype]
        return x.detach().cpu().view(signed).numpy().view(bits)
    return _to_numpy(x)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _stored(leaf)

    _map_with_path(put, tree)
    return flat


def _bits_dtypes(tree) -> dict[str, str]:
    """The dtype names of the leaves stored as bits, by path."""
    dtypes: dict[str, str] = {}

    def put(key, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dtype in _AS_BITS:
            dtypes[key] = str(leaf.dtype).removeprefix("torch.")

    _map_with_path(put, tree)
    return dtypes


def save(directory: str, step: int, state: Any, extra: dict | None = None
         ) -> str:
    """Blocking save. ``state`` is any tree of tensors or arrays."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, dtypes = _flatten(state), _bits_dtypes(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "num_arrays": len(flat),
        "total_bytes": int(sum(a.nbytes for a in flat.values())),
        "arrays_sha256": _sha256_file(os.path.join(tmp, "arrays.npz")),
        "extra": extra or {},
    }
    if dtypes:
        manifest["dtypes"] = dtypes
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_copy(_key, x):
    # a copy, never a view: on the CPU ``tensor.numpy()`` shares memory,
    # and an engine writing its carry in place would tear the bytes the
    # background thread is writing
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class AsyncCheckpointer:
    """Device->host copy on the caller thread; disk write in background."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, extra: dict | None = None) -> None:
        self.wait()
        host_state = _map_with_path(_host_copy, state)  # sync copy out

        def work():
            try:
                save(self.directory, step, host_state, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.directory))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def load_arrays(directory: str, step: int, verify: bool = True
                ) -> dict[str, np.ndarray]:
    """Read a step's arrays as a ``{path: ndarray}`` dict, fully
    materialized, raising :class:`CheckpointCorruptError` on truncated or
    garbled files.  ``verify=True`` (default) additionally checks the
    manifest's ``arrays_sha256`` when present."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    if verify:
        sha = read_manifest(directory, step).get("arrays_sha256")
        if sha is not None:
            try:
                actual = _sha256_file(path)
            except OSError as e:
                raise CheckpointCorruptError(path, f"unreadable: {e}") \
                    from e
            if actual != sha:
                raise CheckpointCorruptError(
                    path, f"SHA-256 mismatch: manifest says {sha[:12]}…, "
                          f"file hashes to {actual[:12]}… (truncated write "
                          "or on-disk corruption)")
    try:
        with np.load(path, allow_pickle=False) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    except Exception as e:
        # zipfile.BadZipFile, EOFError, OSError, ValueError from a garbage
        # member, KeyError from a torn index — one typed error, named path
        raise CheckpointCorruptError(
            path, f"{type(e).__name__}: {e}") from e


def verify_step(directory: str, step: int) -> None:
    """Raise :class:`CheckpointCorruptError` unless step ``step`` is fully
    readable (manifest parses, arrays decompress, checksum matches)."""
    load_arrays(directory, step, verify=True)


def latest_valid_step(directory: str) -> tuple[int | None, list[int]]:
    """Newest step that verifies, plus the (newer) corrupt steps skipped
    on the way — the rollback primitive: ``(None, [...])`` means no
    checkpoint survived at all."""
    corrupt: list[int] = []
    for step in reversed(list_steps(directory)):
        try:
            verify_step(directory, step)
        except CheckpointCorruptError:
            corrupt.append(step)
        else:
            return step, corrupt
    return None, corrupt


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays; only its structure and leaf devices are read).  Leaves come
    back as tensors with the stored dtypes (a leaf stored as bits with the
    dtype its manifest names), on ``device`` when given, else on the
    device of the matching ``like`` leaf (the CPU for arrays)."""
    data = load_arrays(directory, step)
    dtypes = read_manifest(directory, step).get("dtypes", {})
    keys: list[str] = []
    _map_with_path(lambda key, _leaf: keys.append(key), like)
    missing = set(keys) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing arrays: {sorted(missing)[:5]}...")

    def place(key, leaf):
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        x = data[key]
        if key in dtypes:
            dt = getattr(torch, dtypes[key])
            signed = _AS_BITS[dt][0]
            x = torch.from_numpy(x.view(str(signed).removeprefix(
                "torch."))).view(dt)
            return x.to(dev)
        return torch.from_numpy(x).to(dev)

    return _map_with_path(place, like)


def read_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            path, f"{type(e).__name__}: {e}") from e