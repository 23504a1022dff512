"""Shape-keyed launch tuner with a persistent JSON tuning cache (torch
port of ``repro.core.engine.tuning``).

The engines expose a launch knob whose best value depends only on the
launch SHAPE, not on the realized randomness: ``work_steps``, the bound of
the per-slot placement work list.  This module sweeps it per

    (policy, engine, backend, L, K, R, Qcap, A_max)

shape, verifies every candidate BIT-MATCHES the untuned run before it can
win (a faster-but-divergent value is rejected, never cached), and stores
winners in a persistent JSON cache that later runs pick up on their own:
``run_policy`` / ``run_policy_streams`` / ``monte_carlo_policy`` /
``stream_policy`` / ``serving.engine.estimate_capacity`` consult it
(:func:`apply_tuned`) whenever the caller did not pin the knob.

The JAX package also tunes ``window``, the Pallas kernels' VMEM time
window.  The port's CUDA kernels loop over every slot inside one thread
block and only validate ``window`` (``kernels.common.resolve_windows``), so
it costs nothing, and it is neither swept nor cached here.

Cache contract:

  * location: ``REPRO_TORCH_TUNING_CACHE`` > ``~/.cache/repro_torch/
    sched_tuning.json``.  The port keeps a file of its own and never reads
    or rewrites the JAX package's ``REPRO_TUNING_CACHE`` file;
  * the value ``off`` disables lookups and writes.  The cache is also off
    when ``REPRO_TORCH_TUNING_CACHE`` is unset and the JAX package's
    ``REPRO_TUNING_CACHE`` is ``off`` — the one place the port reads that
    variable, so that one switch (the test suite's) keeps both packages
    hermetic;
  * writes are atomic (tmp file + ``os.replace``, the rule of
    ``repro_torch.checkpoint``), so a killed sweep never leaves a torn
    cache;
  * a corrupt or schema-mismatched cache file is IGNORED with a loud
    warning and overwritten by the next store;
  * entries are keyed by the full launch shape and the backend (the device
    type of the run: ``cuda`` or ``cpu``) and carry the module ``SCHEMA``;
    bumping it discards every stale entry;
  * ``engine="reference"`` is bypassed (nothing to tune), and ``autotune``
    refuses ``engine="cuda"`` on CPU tensors, where the kernel's plain
    version runs and its timings do not transfer (``allow_plain=True``
    overrides, e.g. in tests).

A tuned ``work_steps`` is still only a bound: another workload at the same
shape may need more steps, and then the engines' ``truncated`` counter
reports it — the bit-match contract is enforced at run time, not assumed
from the cache.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import warnings

import torch

#: Bumping this discards every previously cached entry.
SCHEMA = "tuning.v1"

_ENV = "REPRO_TORCH_TUNING_CACHE"
#: The JAX package's variable: read only for its ``off`` value.
_JAX_ENV = "REPRO_TUNING_CACHE"
_DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch",
                             "sched_tuning.json")

#: Shape-key defaults, the policy runners' signature defaults, so a knob
#: the caller leaves unset keys the shape the runner will use.
_SHAPE_DEFAULTS = {"L": 8, "K": 16, "Qcap": 512, "A_max": 8}


def cache_path() -> str | None:
    """Resolved cache file path, or None when tuning is off."""
    raw = os.environ.get(_ENV, "")
    if raw.lower() == "off":
        return None
    if not raw and os.environ.get(_JAX_ENV, "").lower() == "off":
        return None
    return os.path.expanduser(raw or _DEFAULT_PATH)


def tuning_enabled() -> bool:
    return cache_path() is not None


def shape_key(policy: str, engine: str, *, L: int, K: int, R: int,
              Qcap: int, A_max: int, backend: str = "cuda") -> str:
    """The cache key of one launch shape (stable, human-readable);
    ``backend`` is the device type the run uses."""
    return (f"{policy}|{engine}|{backend}|L={L}|K={K}|R={R}|"
            f"Qcap={Qcap}|A_max={A_max}")


class TuningCache:
    """Persistent shape-key -> winner map (atomic JSON writes)."""

    def __init__(self, path: str | None = None):
        self.path = cache_path() if path is None else os.path.expanduser(path)

    def load(self) -> dict:
        """All valid entries; corrupt or stale files are ignored loudly."""
        if self.path is None or not os.path.exists(self.path):
            return {}
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            warnings.warn(
                f"ignoring corrupt tuning cache at {self.path!r} ({e}); "
                "it will be overwritten by the next store", stacklevel=2)
            return {}
        if not isinstance(data, dict) or data.get("schema") != SCHEMA:
            warnings.warn(
                f"ignoring tuning cache at {self.path!r}: schema "
                f"{data.get('schema') if isinstance(data, dict) else None!r}"
                f" != {SCHEMA!r} (stale entries are discarded, not reused)",
                stacklevel=2)
            return {}
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def get(self, key: str) -> dict | None:
        entry = self.load().get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        """Read-merge-replace with an atomic tmp-then-rename write."""
        if self.path is None:
            return
        entries = self.load()
        entries[key] = entry
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": SCHEMA, "entries": entries}, f,
                          indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def _shape_of(config: dict, num_resources: int) -> dict:
    shape = {k: int(config.get(k, d)) for k, d in _SHAPE_DEFAULTS.items()}
    shape["R"] = int(num_resources)
    return shape


def _backend(config: dict) -> str:
    """The device type a runner given ``config`` uses: its ``device=``, the
    card when that is unset."""
    device = config.get("device")
    return "cuda" if device is None else torch.device(device).type


def apply_tuned(policy: str, engine: str, config: dict,
                num_resources: int = 1, cache: TuningCache | None = None,
                backend: str | None = None) -> dict:
    """Fill an unset ``work_steps`` from the tuning cache, in place.

    Only a knob the caller left unset (absent or None) is filled; an
    explicit ``work_steps=`` always wins.  ``backend`` is the run's device
    type (default: that of ``config["device"]``, the card when unset).
    Returns ``{"tuned": 0|1, "cache_hit": 0|1}`` (``tuned``: a knob was
    injected; ``cache_hit``: the shape had an entry)."""
    meta = {"tuned": 0, "cache_hit": 0}
    if engine == "reference" or not tuning_enabled():
        return meta
    cache = cache or TuningCache()
    shape = _shape_of(config, num_resources)
    backend = _backend(config) if backend is None else backend
    entry = cache.get(shape_key(policy, engine, backend=backend, **shape))
    if entry is None:
        return meta
    meta["cache_hit"] = 1
    if config.get("work_steps") is None \
            and entry.get("work_steps") is not None:
        config["work_steps"] = int(entry["work_steps"])
        meta["tuned"] = 1
    return meta


def _bitmatch(a, b) -> bool:
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x, y):
            return False
    return True


def _default_grid(A_max: int) -> list[int]:
    default_ws = A_max + 4  # resolve_work_steps' default bound
    return sorted({1, 2, 3, 4, 6, 8, default_ws, 2 * default_ws})


def autotune(workload, seeds, *, policy: str = "bfjs", engine: str = "scan",
             work_steps_grid=None, rounds: int = 3,
             cache: TuningCache | None = None, allow_plain: bool = False,
             **config) -> dict:
    """Sweep ``work_steps`` for one launch shape and cache the verified
    winner.

    Runs the policy's Monte-Carlo (``get_policy(policy).monte_carlo``)
    once per candidate on the SAME seeds and rejects any candidate whose
    result is not bit-identical to the untuned baseline or whose
    ``truncated`` is nonzero; then times the survivors and the baseline
    round-robin, best of ``rounds`` (interleaved, so load drift hits every
    candidate alike; each run synchronises its device).  The fastest
    verified value — the default (None) when nothing beats it — is stored
    under the launch's :func:`shape_key` and returned:

        {"work_steps": ..., "us": ..., "baseline_us": ..., "speedup": ...,
         "key": ..., "candidates": N, "rejected": M}

    ``candidates`` counts the surviving values.  ``engine="reference"``
    has no launch knob and is refused; so is ``engine="cuda"`` on the CPU,
    where the kernel's plain version runs, unless ``allow_plain=True``."""
    from .api import get_policy

    if engine == "reference":
        raise ValueError("engine=\"reference\" has no launch knobs to tune")
    backend = _backend(config)
    if engine == "cuda" and backend != "cuda" and not allow_plain:
        raise ValueError(
            f"refusing to autotune engine=\"cuda\" on {backend} tensors: "
            "there the kernel's plain version runs, and its timings do not "
            "transfer to the kernel (pass allow_plain=True to override)")
    if not tuning_enabled():
        raise ValueError(
            f"tuning cache is disabled ({_ENV}=off, or {_JAX_ENV}=off with "
            f"{_ENV} unset); autotune would sweep and then discard the "
            "winner")
    cache = cache or TuningCache()
    run = get_policy(policy).monte_carlo
    shape = _shape_of(config, workload.num_resources)
    grid = _default_grid(shape["A_max"]) if work_steps_grid is None \
        else sorted({int(w) for w in work_steps_grid})
    base_cfg = dict(config)
    base_cfg.pop("work_steps", None)
    base_cfg.pop("window", None)
    seeds = [int(s) for s in seeds]

    def sync(res):
        if res.queue_len.is_cuda:
            torch.cuda.synchronize(res.queue_len.device)
        return res

    def runner(ws):
        kw = dict(base_cfg)
        if ws is not None:
            kw["work_steps"] = ws
        return sync(run(workload, seeds, engine=engine, **kw))

    baseline = runner(None)
    cands, rejected = [], 0
    for ws in grid:
        res = runner(ws)
        if int(res.truncated.sum()) != 0 or not _bitmatch(res, baseline):
            rejected += 1
            continue
        cands.append(ws)
    best = {c: float("inf") for c in cands + [None]}
    for _ in range(max(rounds, 1)):
        for c in best:
            t0 = time.perf_counter()
            runner(c)
            best[c] = min(best[c], time.perf_counter() - t0)
    base_us = best.pop(None) * 1e6
    win = min(best, key=best.get) if best else None
    win_us = base_us if win is None else best[win] * 1e6
    if win_us > base_us:  # nothing beat the default: record the default
        win, win_us = None, base_us
    key = shape_key(policy, engine, backend=backend, **shape)
    entry = {**shape, "policy": policy, "engine": engine,
             "backend": backend, "work_steps": win, "us": round(win_us, 3),
             "baseline_us": round(base_us, 3),
             "speedup": round(base_us / win_us, 4)}
    cache.put(key, entry)
    return {**entry, "key": key, "candidates": len(cands),
            "rejected": rejected}
