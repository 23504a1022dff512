"""Maximum supportable workload rho* and the Theorem-1 machinery.

* ``enumerate_configs``  — all feasible configurations of a finite-type
  system (Definition 1), by bounded DFS.
* ``rho_star_discrete``  — Eq. (4): the LP
      max  t   s.t.  t * P_j <= L * sum_k p_k k_j,  sum_k p_k <= 1,  p >= 0
  solved with an in-repo dense simplex (Bland's rule; no scipy).
* ``quantile_partition`` / ``rounded_types`` / ``rho_bounds`` — the
  upper/lower-rounded virtual-queue bounds rho_bar*(X^(n)) / rho_lower*(X^(n))
  of Theorem 1 under the quantile partitions X^(n); both converge to rho*.
* ``rho_star_upper_bound`` — Lemma 1: rho* <= L / mean(R).

Copied from ``repro.core.stability``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import numpy as np

from .distributions import JobSizeDistribution
from .quantize import RES, to_grid

MAX_CONFIGS = 500_000


# ---------------------------------------------------------------------------
# feasible configuration enumeration
# ---------------------------------------------------------------------------
def enumerate_configs(sizes_int: np.ndarray, capacity: int = RES,
                      max_configs: int = MAX_CONFIGS) -> np.ndarray:
    """All maximal-or-smaller feasible configurations (including zero).

    Returns an int array (N, J). Raises if the count exceeds ``max_configs``
    (the paper's point: this explodes with the number of types).
    """
    sizes = np.asarray(sizes_int, dtype=np.int64)
    J = len(sizes)
    out: list[tuple[int, ...]] = []
    cur = [0] * J

    def rec(j: int, remaining: int) -> None:
        if len(out) > max_configs:
            raise RuntimeError(f"configuration count exceeds {max_configs}")
        if j == J:
            out.append(tuple(cur))
            return
        max_k = remaining // sizes[j] if sizes[j] > 0 else 0
        for k in range(int(max_k) + 1):
            cur[j] = k
            rec(j + 1, remaining - k * int(sizes[j]))
        cur[j] = 0

    rec(0, int(capacity))
    return np.array(out, dtype=np.int64)


def maximal_configs(configs: np.ndarray, sizes_int: np.ndarray,
                    capacity: int = RES) -> np.ndarray:
    """Filter to maximal configurations (no job of any type can be added)."""
    sizes = np.asarray(sizes_int, dtype=np.int64)
    used = configs @ sizes
    resid = capacity - used
    can_add = resid[:, None] >= sizes[None, :]
    return configs[~can_add.any(axis=1)]


# ---------------------------------------------------------------------------
# dense simplex (maximize c^T x, A x <= b, x >= 0), Bland's rule
# ---------------------------------------------------------------------------
def _simplex(c: np.ndarray, A: np.ndarray, b: np.ndarray,
             max_iter: int = 100_000) -> tuple[float, np.ndarray]:
    m, n = A.shape
    if np.any(b < -1e-12):
        raise ValueError("b must be >= 0 (slack basis start)")
    # tableau: [A | I | b], objective row: [-c | 0 | 0]
    T = np.zeros((m + 1, n + m + 1))
    T[:m, :n] = A
    T[:m, n : n + m] = np.eye(m)
    T[:m, -1] = b
    T[m, :n] = -c
    basis = list(range(n, n + m))

    basis_arr = np.asarray(basis)
    for _ in range(max_iter):
        # Bland: entering = smallest index with negative reduced cost
        neg = np.nonzero(T[m, :-1] < -1e-10)[0]
        if neg.size == 0:
            break  # optimal
        enter = int(neg[0])
        col = T[:m, enter]
        pos = col > 1e-10
        if not pos.any():
            raise RuntimeError("LP unbounded")
        ratios = np.where(pos, T[:m, -1] / np.where(pos, col, 1.0), np.inf)
        best = ratios.min()
        ties = np.nonzero(ratios <= best + 1e-12)[0]
        # Bland tie-break: smallest basis-variable index
        leave = int(ties[np.argmin(basis_arr[ties])])
        piv = T[leave, enter]
        T[leave] /= piv
        factors = T[:, enter].copy()
        factors[leave] = 0.0
        T -= np.outer(factors, T[leave])
        basis_arr[leave] = enter
    else:
        raise RuntimeError("simplex iteration limit")
    basis = basis_arr.tolist()

    x = np.zeros(n + m)
    for i, bi in enumerate(basis):
        x[bi] = T[i, -1]
    return float(T[m, -1]), x[:n]


def rho_star_discrete(sizes: np.ndarray, probs: np.ndarray, L: int = 1,
                      capacity: int = RES, configs: np.ndarray | None = None,
                      max_configs: int = MAX_CONFIGS) -> float:
    """Maximum supportable workload rho* (Eq. 4) for a finite-type system.

    ``sizes`` may be floats in (0,1] (quantized to the grid) or grid ints.
    """
    sizes = np.asarray(sizes)
    if sizes.dtype.kind == "f":
        sizes_int = to_grid(sizes)
    else:
        sizes_int = sizes.astype(np.int64)
    P = np.asarray(probs, dtype=np.float64)
    keep = P > 0
    sizes_int, P = sizes_int[keep], P[keep]
    if configs is None:
        configs = enumerate_configs(sizes_int, capacity, max_configs)
        configs = maximal_configs(configs, sizes_int, capacity)
    K, J = configs.shape
    # variables x = [t, p_1..p_K]
    # constraints: t P_j - L sum_k p_k k_j <= 0  (J rows);  sum p <= 1
    A = np.zeros((J + 1, K + 1))
    A[:J, 0] = P
    A[:J, 1:] = -float(L) * configs.T
    A[J, 1:] = 1.0
    b = np.zeros(J + 1)
    b[J] = 1.0
    c = np.zeros(K + 1)
    c[0] = 1.0
    val, _ = _simplex(c, A, b)
    return val


def rho_star_upper_bound(dist: JobSizeDistribution, L: int) -> float:
    """Lemma 1: rho* <= L / E[R]."""
    return L / dist.mean()


# ---------------------------------------------------------------------------
# Theorem 1: quantile partitions and rounded bounds
# ---------------------------------------------------------------------------
def quantile_partition(dist: JobSizeDistribution, n: int) -> np.ndarray:
    """Boundaries xi_0=0 < xi_1 < ... < xi_{2^{n+1}} = 1 with
    F_R(xi_i) = i / 2^{n+1} (continuous F_R)."""
    m = 1 << (n + 1)
    qs = np.arange(1, m) / m
    xs = np.asarray(dist.quantile(qs), dtype=np.float64)
    return np.concatenate([[0.0], xs, [1.0]])


def rounded_types(dist: JobSizeDistribution, boundaries: np.ndarray,
                  rounding: str) -> tuple[np.ndarray, np.ndarray]:
    """(sizes, probs) of the finite-type system with sizes rounded to the
    upper (sup) or lower (inf) edge of each partition interval.

    Lower-rounding drops types rounded to 0 (they consume no resource,
    paper Appendix A)."""
    lo, hi = boundaries[:-1], boundaries[1:]
    probs = np.asarray(dist.cdf(hi)) - np.asarray(dist.cdf(lo))
    if rounding == "upper":
        sizes = hi
    elif rounding == "lower":
        sizes = lo
    else:
        raise ValueError(rounding)
    keep = (probs > 1e-15) & (sizes > 0)
    return sizes[keep], probs[keep]


def rho_bounds(dist: JobSizeDistribution, n: int, L: int = 1,
               max_configs: int = MAX_CONFIGS) -> tuple[float, float]:
    """(rho_bar*(X^(n)), rho_lower*(X^(n))) — Theorem 1's two bounds; the true
    rho* lies between them and both converge as n grows."""
    bounds = quantile_partition(dist, n)
    up_s, up_p = rounded_types(dist, bounds, "upper")
    lo_s, lo_p = rounded_types(dist, bounds, "lower")
    upper = rho_star_discrete(up_s, up_p, L, max_configs=max_configs)
    lower = rho_star_discrete(lo_s, lo_p, L, max_configs=max_configs)
    return upper, lower
