"""Workload-first policy entry points (torch port of
``repro.core.engine.api``: policies "bfjs", "bfjs-mr", "vqs" and
"vqs-bf").

    wl = Workload(lam=17.0, mu=0.01, sampler=sampler)
    run_policy(wl, seed, policy="bfjs", engine="cuda", L=1000, ...)
    run_policy(wl, seed, policy="vqs", engine="cuda", J=4, L=1000, ...)
    run_policy_streams(streams, policy="bfjs", engine="scan", ...)
    monte_carlo_policy(wl, seeds=range(128), policy="bfjs", engine="cuda",
                       ...)
    monte_carlo_policy(wl2, seeds=range(128), policy="bfjs-mr",
                       engine="cuda", L=1000, ...)   # wl2: R = 2 resources

``engine`` is ``"scan"`` (batched plain torch ops), ``"cuda"`` (the
policy's hand-written kernel; it bit-matches "scan") or ``"reference"``
(the policy's oracle on the host, the behavioural anchor the other two
equal whenever ``truncated == 0``).  bfjs's oracle is defined by its own
draws, so, as in the JAX package, ``run_policy_streams`` refuses it.
Randomness is seeded by integers — one per ensemble member — in place of
the JAX package's PRNG keys.  Entry points run on the card unless
``device="cpu"`` is passed.

``chunk=`` / ``checkpoint_dir=`` / ``resume=`` / ``stop_after_chunks=``
run a crash-safe chunked sweep on the scan engine
(``core.engine.chunked``), and ``audit=True`` holds the result to the
runtime invariants (``core.engine.supervisor.audit_result``).  ``mesh=`` /
``devices=`` split the ensemble over devices (``core.engine.sharding``),
bit-identical to the unsharded run.  An unset ``work_steps`` is filled
from the tuning cache (``core.engine.tuning``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .bfjs import (ENGINES, monte_carlo_bfjs_workload, run_bfjs_trace,
                   run_bfjs_workload)
from .bfjs_mr import (monte_carlo_bfjs_mr_workload, run_bfjs_mr_trace,
                      run_bfjs_mr_workload)
from .chunked import run_chunked
from .sharding import (monte_carlo_chunked, resolve_mesh,
                       sharded_monte_carlo)
from .streams import PolicyResult, SchedStreams
from .supervisor import audit_result
from .tuning import apply_tuned
from .vqs import monte_carlo_vqs_workload, run_vqs_trace, run_vqs_workload
from .vqs_bf import (monte_carlo_vqs_bf_workload, run_vqs_bf_trace,
                     run_vqs_bf_workload)
from .workload import Workload


@dataclass(frozen=True)
class PolicySpec:
    """Engine implementations of one scheduling policy."""
    name: str
    run: Callable[..., PolicyResult]          # (workload, seed, ...)
    run_streams: Callable[..., PolicyResult]  # (streams, ...)
    monte_carlo: Callable[..., PolicyResult]  # (workload, seeds, ...)


_POLICIES: dict[str, PolicySpec] = {}


def register_policy(spec: PolicySpec) -> PolicySpec:
    if spec.name in _POLICIES:
        raise ValueError(f"policy {spec.name!r} already registered")
    _POLICIES[spec.name] = spec
    return spec


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def get_policy(policy: str) -> PolicySpec:
    try:
        return _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; registered: "
            f"{', '.join(available_policies())}") from None


def _check_engine(engine: str, policy: str) -> None:
    get_policy(policy)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{', '.join(ENGINES)}")


def _chunked_only(engine: str, chunk: int | None) -> None:
    """The checks of a checkpointed chunked request: the scan engine (its
    carry is the whole simulation state; the kernels keep theirs in shared
    memory for one launch) and a chunk length."""
    if engine != "scan":
        raise ValueError(
            f'checkpointed chunked sweeps need engine="scan" (its '
            f"carry is the entire simulation state); got "
            f"engine={engine!r}")
    if chunk is None:
        raise ValueError("checkpoint_dir=/resume= need chunk= (the "
                         "boundary interval, in slots)")


register_policy(PolicySpec(
    name="bfjs",
    run=run_bfjs_workload,
    run_streams=run_bfjs_trace,
    monte_carlo=monte_carlo_bfjs_workload,
))
register_policy(PolicySpec(
    name="bfjs-mr",
    run=run_bfjs_mr_workload,
    run_streams=run_bfjs_mr_trace,
    monte_carlo=monte_carlo_bfjs_mr_workload,
))
register_policy(PolicySpec(
    name="vqs",
    run=run_vqs_workload,
    run_streams=run_vqs_trace,
    monte_carlo=monte_carlo_vqs_workload,
))
register_policy(PolicySpec(
    name="vqs-bf",
    run=run_vqs_bf_workload,
    run_streams=run_vqs_bf_trace,
    monte_carlo=monte_carlo_vqs_bf_workload,
))


def _require_workload(fn_name: str, workload) -> None:
    if not isinstance(workload, Workload):
        raise TypeError(f"{fn_name} takes a repro_torch Workload, got "
                        f"{type(workload).__name__}")


def run_policy(workload: Workload, seed: int = 0, *, policy: str = "bfjs",
               engine: str = "scan", **config) -> PolicyResult:
    """Simulate one cluster under ``policy`` with the chosen ``engine``.

    ``seed`` seeds the stream generator; ``config`` passes through to the
    policy runner (``L``, ``K``, ``Qcap``, ``A_max``, ``horizon``,
    ``work_steps``, ``device``, and ``J`` for the VQS policies, ...); an
    unset ``work_steps`` comes from the tuning cache."""
    _check_engine(engine, policy)
    _require_workload("run_policy", workload)
    apply_tuned(policy, engine, config, workload.num_resources)
    return get_policy(policy).run(workload, seed, engine=engine, **config)


def run_policy_streams(streams: SchedStreams, *, policy: str = "bfjs",
                       engine: str = "scan",
                       checkpoint_dir: str | None = None,
                       chunk: int | None = None, resume: bool = False,
                       stop_after_chunks: int | None = None,
                       mesh=None, devices=None, audit: bool = False,
                       **config) -> PolicyResult:
    """Replay explicit streams (one cluster, or an ensemble with a leading
    G axis) through a policy engine, on the streams' device.

    ``chunk=``/``checkpoint_dir=`` turn the sweep crash-safe: the scan
    engine runs in ``chunk``-slot pieces, persisting its complete carry at
    every boundary (atomic rename) so ``resume=True`` continues a killed
    sweep BIT-EXACTLY where it stopped (``core.engine.chunked``).  Only
    ``engine="scan"`` supports this; any other engine raises.

    For streams that are NOT fully materialized — an unbounded arrival
    iterator, a trace read chunk by chunk — use
    ``core.engine.stream_policy``, which threads the same carried state
    through any chunk iterator and bit-matches this function on any
    finite trace.

    ``audit=True`` runs the runtime invariant auditor over the finished
    result (``core.engine.supervisor.audit_result`` — job conservation,
    capacity bounds, fault accounting) and raises a typed
    ``InvariantViolation`` naming the failed counter; it needs explicit
    ``L=``/``K=`` in the config.

    Ensemble-batched streams (a leading G axis) may add ``mesh=`` /
    ``devices=`` to the chunked path, splitting each chunk's members over
    devices (``core.engine.sharding``); without ``chunk=`` they raise."""
    _check_engine(engine, policy)
    mesh = resolve_mesh(mesh, devices)
    n_res = 1 if streams.sizes.ndim == streams.durs.ndim \
        else int(streams.sizes.shape[-1])
    apply_tuned(policy, engine, config, n_res,
                backend=(streams.n.device if mesh is None else mesh[0]).type)
    audit_cfg = dict(config)

    def _audited(res: PolicyResult) -> PolicyResult:
        if audit:
            audit_result(streams, res, policy=policy, config=audit_cfg)
        return res

    if chunk is not None or checkpoint_dir is not None or resume:
        _chunked_only(engine, chunk)
        return _audited(run_chunked(
            streams, policy=policy, chunk=chunk,
            checkpoint_dir=checkpoint_dir, resume=resume,
            stop_after_chunks=stop_after_chunks, mesh=mesh, **config))
    if mesh is not None:
        raise ValueError(
            "mesh=/devices= on run_policy_streams needs the chunked path "
            "(chunk=); for straight sharded Monte-Carlo use "
            "monte_carlo_policy(..., mesh=)")
    return _audited(get_policy(policy).run_streams(streams, engine=engine,
                                                   **config))


def monte_carlo_policy(workload: Workload, seeds=None, *,
                       policy: str = "bfjs", engine: str = "scan",
                       mesh=None, devices=None,
                       chunk: int | None = None,
                       checkpoint_dir: str | None = None,
                       resume: bool = False,
                       stop_after_chunks: int | None = None,
                       **config) -> PolicyResult:
    """One simulated cluster per integer seed, batched on a leading G axis;
    "cuda" runs the ensemble as the kernel's grid of thread blocks.

    ``mesh=`` (a device sequence) or ``devices=`` (an int, the first N
    cards, or a device sequence, repeats allowed) splits the members over
    devices, bit-identical to the unsharded run, one G/D shard per entry
    (``core.engine.sharding``; ``engine="reference"`` ignores the mesh).
    ``chunk=``/``checkpoint_dir=``/``resume=`` run the sweep crash-safe in
    T-chunks on the scan engine (``sharding.monte_carlo_chunked``),
    composing with the mesh; checkpoints name no device count, so a sweep
    may resume on another.  An unset ``work_steps`` comes from the tuning
    cache."""
    _check_engine(engine, policy)
    _require_workload("monte_carlo_policy", workload)
    if seeds is None:
        raise TypeError("monte_carlo_policy needs seeds= (one integer seed "
                        "per ensemble member)")
    mesh = resolve_mesh(mesh, devices)
    apply_tuned(policy, engine, config, workload.num_resources,
                backend=None if mesh is None else mesh[0].type)
    if chunk is not None or checkpoint_dir is not None or resume:
        _chunked_only(engine, chunk)
        return monte_carlo_chunked(workload, seeds, policy=policy,
                                   chunk=chunk, mesh=mesh,
                                   checkpoint_dir=checkpoint_dir,
                                   resume=resume,
                                   stop_after_chunks=stop_after_chunks,
                                   **config)
    if mesh is not None:
        return sharded_monte_carlo(workload, seeds, policy=policy,
                                   mesh=mesh, engine=engine, **config)
    return get_policy(policy).monte_carlo(workload, seeds, engine=engine,
                                          **config)
