"""Ensemble Monte-Carlo over chunks (torch counterpart of
``repro.core.engine.sharding``).

Only the single-device half is ported so far: :func:`monte_carlo_chunked`.
Splitting the ensemble over several cards (``mesh=`` / ``devices=``) waits
for ROADMAP queue 1 item 9.
"""
from __future__ import annotations

from ...device import resolve_device
from .bfjs import ensemble_streams
from .chunked import run_chunked
from .streams import PolicyResult


def monte_carlo_chunked(workload, seeds, *, policy: str = "bfjs",
                        chunk: int, checkpoint_dir: str | None = None,
                        resume: bool = False,
                        stop_after_chunks: int | None = None,
                        horizon: int = 10_000, fault_rate: float = 0.0,
                        repair_rate: float = 1.0, device=None,
                        **config) -> PolicyResult:
    """Crash-safe chunked Monte-Carlo: one member per integer seed.

    Generates the whole ensemble's streams on ``device`` (default: the
    card), member g equal to the straight Monte-Carlo path's member g, then
    runs :func:`~repro_torch.core.engine.chunked.run_chunked` over them,
    every member batched in each chunk.  Checkpoints store the full
    ``(G, ...)`` carry host-side and name no device."""
    if policy != "bfjs-mr":
        workload.require_scalar(policy)
    workload.check_sampler()
    streams = ensemble_streams(
        seeds, workload.lam, workload.mu, workload.sampler,
        L=config.get("L", 8), K=config.get("K", 16),
        A_max=config.get("A_max", 8), horizon=horizon,
        device=resolve_device(device),
        num_resources=workload.num_resources, fault_rate=fault_rate,
        repair_rate=repair_rate)
    if policy == "bfjs-mr" and "capacity" not in config:
        config["capacity"] = workload.capacity
    return run_chunked(streams, policy=policy, chunk=chunk,
                       checkpoint_dir=checkpoint_dir, resume=resume,
                       stop_after_chunks=stop_after_chunks, **config)
