"""First-class workload specification for the engine entry points (torch
port of ``repro.core.engine.workload``).

    wl = Workload(lam=17.0, mu=0.01, sampler=sampler)   # R = 1
    monte_carlo_policy(wl, seeds=range(128), policy="bfjs", ...)

``sampler(generator, n, device)`` must return ``(n,)`` float sizes in
(0, 1] when ``num_resources == 1`` and ``(n, R)`` demand vectors otherwise,
drawn from the ``torch.Generator`` it is given on ``device``.
``check_sampler`` calls it once at ``n=2`` on the CPU before any stream is
generated.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Workload:
    """One cluster workload: arrivals, sizes, service, resource geometry.

    Attributes:
      lam: Poisson arrival rate (jobs per slot).
      mu: geometric service rate (mean service time ``1/mu`` slots).
      sampler: ``sampler(generator, n, device) -> (n,)`` sizes (``R == 1``)
        or ``(n, R)`` demand vectors (``R > 1``), values in (0, 1].
      num_resources: R, the length of every job's requirement vector.
      capacity: per-resource server capacity — a scalar (broadcast to all R
        resources) or a length-R tuple.  Normalized to a tuple of floats.
    """

    lam: float
    mu: float
    sampler: Callable[[torch.Generator, int, object], torch.Tensor]
    num_resources: int = 1
    capacity: float | tuple[float, ...] = 1.0

    def __post_init__(self):
        if not isinstance(self.num_resources, int) or self.num_resources < 1:
            raise ValueError(
                f"num_resources must be a positive int, got "
                f"{self.num_resources!r}")
        if self.lam < 0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")
        if not 0 < self.mu <= 1:
            raise ValueError(f"mu must be in (0, 1], got {self.mu}")
        cap = self.capacity
        if not isinstance(cap, tuple):
            cap = (float(cap),) * self.num_resources
        else:
            cap = tuple(float(c) for c in cap)
        if len(cap) != self.num_resources:
            raise ValueError(
                f"capacity has {len(cap)} entries for num_resources="
                f"{self.num_resources}")
        if any(c <= 0 for c in cap):
            raise ValueError(f"capacity entries must be > 0, got {cap}")
        object.__setattr__(self, "capacity", cap)

    # -- validation ---------------------------------------------------------
    def check_sampler(self) -> None:
        """Shape-check ``sampler`` against ``num_resources``: one call
        ``sampler(generator, 2, "cpu")`` must give ``(2,)`` for R == 1 and
        ``(2, R)`` for R > 1."""
        gen = torch.Generator(device="cpu").manual_seed(0)
        out = self.sampler(gen, 2, torch.device("cpu"))
        expect = (2,) if self.num_resources == 1 else (2, self.num_resources)
        if tuple(out.shape) != expect:
            raise ValueError(
                f"sampler output shape {tuple(out.shape)} does not match "
                f"num_resources={self.num_resources}: expected {expect} "
                "for sampler(generator, 2, device)")

    def require_scalar(self, policy: str) -> None:
        """Single-resource engines reject vector workloads loudly."""
        if self.num_resources != 1:
            raise ValueError(
                f"policy {policy!r} is single-resource; this workload has "
                f"num_resources={self.num_resources} — use policy="
                "\"bfjs-mr\" (or collapse the demands first)")
        if self.capacity != (1.0,):
            raise ValueError(
                f"policy {policy!r} supports unit server capacity only, "
                f"got capacity={self.capacity}")

    # -- ergonomics ---------------------------------------------------------
    def replace(self, **changes) -> "Workload":
        return dataclasses.replace(self, **changes)

    @property
    def mean_service(self) -> float:
        return 1.0 / self.mu
