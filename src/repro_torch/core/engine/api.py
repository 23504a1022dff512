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

``engine`` is ``"scan"`` (batched plain torch ops) or ``"cuda"`` (the
policy's hand-written kernel); "cuda" bit-matches "scan".  A policy whose
host oracle is ported also takes ``"reference"`` (so far "bfjs-mr").
Randomness is seeded by integers — one per ensemble member — in place of
the JAX package's PRNG keys.  Entry points run on the card unless
``device="cpu"`` is passed.

The JAX package's mesh sharding, checkpointed chunks and invariant audit
are not ported yet; asking for them raises ``NotImplementedError`` naming
the ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import bfjs, bfjs_mr, vqs
from .bfjs import (monte_carlo_bfjs_workload, run_bfjs_trace,
                   run_bfjs_workload)
from .bfjs_mr import (monte_carlo_bfjs_mr_workload, run_bfjs_mr_trace,
                      run_bfjs_mr_workload)
from .streams import PolicyResult, SchedStreams
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
    engines: tuple[str, ...] = bfjs.ENGINES   # the engines it runs
    reference_todo: str | None = None  # why engine="reference" is not
    #                                    ported yet, where it is not


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
    spec = get_policy(policy)
    if engine in spec.engines:
        return
    if engine == "reference" and spec.reference_todo:
        raise NotImplementedError(spec.reference_todo)
    raise ValueError(f"unknown engine {engine!r} for policy {policy!r}; "
                     f"expected one of {', '.join(spec.engines)}")


def _not_ported(mesh=None, devices=None, chunk=None, checkpoint_dir=None,
                resume=False, stop_after_chunks=None, audit=False) -> None:
    if mesh is not None or devices is not None:
        raise NotImplementedError(
            "mesh=/devices= (ensemble sharding over several cards) is not "
            "ported yet (ROADMAP queue 1 item 9)")
    if chunk is not None or checkpoint_dir is not None or resume \
            or stop_after_chunks is not None:
        raise NotImplementedError(
            "chunk=/checkpoint_dir=/resume= (checkpointed chunked sweeps) "
            "are not ported yet (ROADMAP queue 1 item 7)")
    if audit:
        raise NotImplementedError(
            "audit=True (the runtime invariant auditor) is not ported yet "
            "(ROADMAP queue 1 item 8)")


register_policy(PolicySpec(
    name="bfjs",
    run=run_bfjs_workload,
    run_streams=run_bfjs_trace,
    monte_carlo=monte_carlo_bfjs_workload,
    reference_todo=bfjs._REFERENCE_TODO,
))
register_policy(PolicySpec(
    name="bfjs-mr",
    run=run_bfjs_mr_workload,
    run_streams=run_bfjs_mr_trace,
    monte_carlo=monte_carlo_bfjs_mr_workload,
    engines=bfjs_mr.ENGINES,
))
register_policy(PolicySpec(
    name="vqs",
    run=run_vqs_workload,
    run_streams=run_vqs_trace,
    monte_carlo=monte_carlo_vqs_workload,
    reference_todo=vqs._REFERENCE_TODO,
))
register_policy(PolicySpec(
    name="vqs-bf",
    run=run_vqs_bf_workload,
    run_streams=run_vqs_bf_trace,
    monte_carlo=monte_carlo_vqs_bf_workload,
    reference_todo=vqs._REFERENCE_TODO,
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
    ``work_steps``, ``device``, and ``J`` for the VQS policies, ...)."""
    _check_engine(engine, policy)
    _require_workload("run_policy", workload)
    return get_policy(policy).run(workload, seed, engine=engine, **config)


def run_policy_streams(streams: SchedStreams, *, policy: str = "bfjs",
                       engine: str = "scan",
                       checkpoint_dir: str | None = None,
                       chunk: int | None = None, resume: bool = False,
                       stop_after_chunks: int | None = None,
                       mesh=None, devices=None, audit: bool = False,
                       **config) -> PolicyResult:
    """Replay explicit streams (one cluster, or an ensemble with a leading
    G axis) through a policy engine, on the streams' device."""
    _check_engine(engine, policy)
    _not_ported(mesh=mesh, devices=devices, chunk=chunk,
                checkpoint_dir=checkpoint_dir, resume=resume,
                stop_after_chunks=stop_after_chunks, audit=audit)
    return get_policy(policy).run_streams(streams, engine=engine, **config)


def monte_carlo_policy(workload: Workload, seeds=None, *,
                       policy: str = "bfjs", engine: str = "scan",
                       mesh=None, devices=None,
                       chunk: int | None = None,
                       checkpoint_dir: str | None = None,
                       resume: bool = False,
                       stop_after_chunks: int | None = None,
                       **config) -> PolicyResult:
    """One simulated cluster per integer seed, batched on a leading G axis;
    "cuda" runs the ensemble as the kernel's grid of thread blocks."""
    _check_engine(engine, policy)
    _require_workload("monte_carlo_policy", workload)
    if seeds is None:
        raise TypeError("monte_carlo_policy needs seeds= (one integer seed "
                        "per ensemble member)")
    _not_ported(mesh=mesh, devices=devices, chunk=chunk,
                checkpoint_dir=checkpoint_dir, resume=resume,
                stop_after_chunks=stop_after_chunks)
    return get_policy(policy).monte_carlo(workload, seeds, engine=engine,
                                          **config)
