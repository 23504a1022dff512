"""Job-size distributions F_R over (0, 1].

Every distribution exposes sampling plus the analytic interface the
Theorem-1 machinery needs (cdf / quantile / mean / discrete atoms).

Copied from ``repro.core.distributions``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


class JobSizeDistribution(abc.ABC):
    """cdf F_R: (0,1] -> [0,1]; sizes are normalized resource requirements."""

    @abc.abstractmethod
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        ...

    @abc.abstractmethod
    def cdf(self, x: np.ndarray | float) -> np.ndarray | float:
        ...

    @abc.abstractmethod
    def quantile(self, q: np.ndarray | float) -> np.ndarray | float:
        ...

    @abc.abstractmethod
    def mean(self) -> float:
        ...

    def min_size(self) -> float:
        """Essential infimum of the support (paper's u)."""
        return float(self.quantile(0.0))

    def atoms(self) -> tuple[np.ndarray, np.ndarray]:
        """(locations, probabilities) of discrete atoms; empty if continuous."""
        return np.empty(0), np.empty(0)


@dataclass
class Uniform(JobSizeDistribution):
    """U[a, b] with 0 < a <= b <= 1 (paper Fig. 4 uses [0.01,0.19] / [0.1,0.9])."""

    a: float
    b: float

    def __post_init__(self):
        if not (0.0 < self.a <= self.b <= 1.0):
            raise ValueError(f"need 0 < a <= b <= 1, got [{self.a}, {self.b}]")

    def sample(self, rng, n):
        return rng.uniform(self.a, self.b, size=n)

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        if self.b == self.a:
            return (x >= self.a).astype(np.float64)
        return np.clip((x - self.a) / (self.b - self.a), 0.0, 1.0)

    def quantile(self, q):
        q = np.asarray(q, dtype=np.float64)
        return self.a + q * (self.b - self.a)

    def mean(self):
        return 0.5 * (self.a + self.b)


@dataclass
class Discrete(JobSizeDistribution):
    """Finite-type distribution: P(R = sizes[i]) = probs[i]."""

    sizes: Sequence[float]
    probs: Sequence[float]
    _sizes: np.ndarray = field(init=False, repr=False)
    _probs: np.ndarray = field(init=False, repr=False)
    _cum: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        s = np.asarray(self.sizes, dtype=np.float64)
        p = np.asarray(self.probs, dtype=np.float64)
        if np.any(s <= 0) or np.any(s > 1):
            raise ValueError("sizes must lie in (0, 1]")
        if abs(p.sum() - 1.0) > 1e-9:
            raise ValueError("probs must sum to 1")
        order = np.argsort(s)
        self._sizes, self._probs = s[order], p[order]
        self._cum = np.cumsum(self._probs)

    def sample(self, rng, n):
        idx = rng.choice(len(self._sizes), size=n, p=self._probs)
        return self._sizes[idx]

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        idx = np.searchsorted(self._sizes, x, side="right")
        cum = np.concatenate([[0.0], self._cum])
        return cum[idx]

    def quantile(self, q):
        q = np.asarray(q, dtype=np.float64)
        idx = np.searchsorted(self._cum, q, side="left")
        idx = np.clip(idx, 0, len(self._sizes) - 1)
        return self._sizes[idx]

    def mean(self):
        return float(np.dot(self._sizes, self._probs))

    def min_size(self):
        return float(self._sizes[0])

    def atoms(self):
        return self._sizes.copy(), self._probs.copy()


@dataclass
class TruncatedPareto(JobSizeDistribution):
    """Heavy-tailed sizes on [a, 1]: pdf ~ x^-(alpha+1), truncated.

    Models the skewed memory-request distributions seen in the Google trace
    (many small tasks, a long tail of large ones).
    """

    a: float = 0.01
    alpha: float = 1.1

    def __post_init__(self):
        if not (0 < self.a < 1):
            raise ValueError("a in (0,1)")
        self._za = self.a**-self.alpha
        self._z1 = 1.0
        self._norm = self._za - self._z1

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        x = np.clip(x, self.a, 1.0)
        return (self._za - x**-self.alpha) / self._norm

    def quantile(self, q):
        q = np.asarray(q, dtype=np.float64)
        return (self._za - q * self._norm) ** (-1.0 / self.alpha)

    def sample(self, rng, n):
        return self.quantile(rng.uniform(0.0, 1.0, size=n))

    def mean(self):
        al, a = self.alpha, self.a
        if abs(al - 1.0) < 1e-12:
            raw = np.log(1.0 / a)
        else:
            raw = al / (al - 1.0) * (a ** (1.0 - al) - 1.0) / (a**-al - 1.0)
            return float(raw)
        return float(raw / self._norm * al)


@dataclass
class Mixture(JobSizeDistribution):
    """Mixture of components — e.g. continuous body + discrete spikes,
    matching the 'general distribution' of Theorem 1's appendix."""

    components: Sequence[JobSizeDistribution]
    weights: Sequence[float]

    def __post_init__(self):
        w = np.asarray(self.weights, dtype=np.float64)
        if abs(w.sum() - 1.0) > 1e-9:
            raise ValueError("weights must sum to 1")
        self._w = w

    def sample(self, rng, n):
        which = rng.choice(len(self.components), size=n, p=self._w)
        out = np.empty(n, dtype=np.float64)
        for i, comp in enumerate(self.components):
            mask = which == i
            k = int(mask.sum())
            if k:
                out[mask] = comp.sample(rng, k)
        return out

    def cdf(self, x):
        return sum(w * np.asarray(c.cdf(x)) for w, c in zip(self._w, self.components))

    def quantile(self, q):
        # generic bisection on the mixture cdf
        q = np.atleast_1d(np.asarray(q, dtype=np.float64))
        lo = np.full_like(q, 1e-9)
        hi = np.ones_like(q)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            c = np.asarray(self.cdf(mid))
            lo = np.where(c < q, mid, lo)
            hi = np.where(c >= q, mid, hi)
        return hi if hi.shape else float(hi)

    def mean(self):
        return float(sum(w * c.mean() for w, c in zip(self._w, self.components)))

    def min_size(self):
        return min(c.min_size() for c in self.components)

    def atoms(self):
        locs, ps = [], []
        for w, c in zip(self._w, self.components):
            a_l, a_p = c.atoms()
            locs.append(a_l)
            ps.append(w * a_p)
        return np.concatenate(locs), np.concatenate(ps)


@dataclass
class Empirical(JobSizeDistribution):
    """Empirical distribution of observed sizes (trace replay / bootstrap)."""

    observations: np.ndarray

    def __post_init__(self):
        obs = np.asarray(self.observations, dtype=np.float64)
        obs = obs[(obs > 0) & (obs <= 1.0)]
        if len(obs) == 0:
            raise ValueError("no valid observations in (0,1]")
        self._sorted = np.sort(obs)

    def sample(self, rng, n):
        idx = rng.integers(0, len(self._sorted), size=n)
        return self._sorted[idx]

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.searchsorted(self._sorted, x, side="right") / len(self._sorted)

    def quantile(self, q):
        q = np.asarray(q, dtype=np.float64)
        idx = np.clip((q * len(self._sorted)).astype(int), 0, len(self._sorted) - 1)
        return self._sorted[idx]

    def mean(self):
        return float(self._sorted.mean())

    def min_size(self):
        return float(self._sorted[0])
