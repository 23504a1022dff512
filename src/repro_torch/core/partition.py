"""Universal partition I (paper Eq. 6) and the reduced configuration set
K_RED^(J) (paper Eq. 7, Definition 5), copied from
``repro.core.partition``.

Partition I of (1/2^J, 1] into 2J subintervals (m = 0..J-1):
    I_{2m}   = (2/3 * 2^-m , 2^-m]          "even" types
    I_{2m+1} = (1/2 * 2^-m , 2/3 * 2^-m]    "odd"  types
Jobs with size <= 2^-J map to the last type (2J-1) with size rounded UP to
2^-J (paper Section V.A).  The batched classifier of the engines is
``core.engine.ops.vq_type_of_grid``; :class:`PartitionI` is the host-side
one the event-driven schedulers and the serving admission controller use.

All boundaries are evaluated in exact integer arithmetic on the quantize.RES
grid:  size in I_{2m}  <=>  3*s > 2*(RES >> m)  and  s <= (RES >> m).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .quantize import RES


@dataclass(frozen=True)
class PartitionI:
    """The paper's universal partition with parameter J > 1."""

    J: int

    def __post_init__(self):
        if self.J < 2:
            raise ValueError("J must be >= 2 (paper requires J > 1)")
        if (1 << self.J) > RES:
            raise ValueError("J too large for the integer grid")

    @property
    def num_types(self) -> int:
        return 2 * self.J

    @property
    def min_grid_size(self) -> int:
        """1/2^J on the grid — sizes at/below this join the last VQ."""
        return RES >> self.J

    def type_of(self, sizes_int: np.ndarray) -> np.ndarray:
        """Vectorized type index for grid sizes. Sizes must be in [1, RES]."""
        s = np.asarray(sizes_int, dtype=np.int64)
        # m = number of halvings: size in (RES>>(m+1), RES>>m], found by a
        # descending searchsorted over the J dyadic boundaries
        bounds = RES >> np.arange(1, self.J + 1)  # RES/2, RES/4, ..., RES/2^J
        m = np.searchsorted(-bounds, -s, side="right")
        m = np.minimum(m, self.J - 1)
        upper = RES >> m
        even = 3 * s > 2 * upper  # s > (2/3) * 2^-m
        t = np.where(even, 2 * m, 2 * m + 1)
        small = s <= self.min_grid_size
        return np.where(small, 2 * self.J - 1, t).astype(np.int64)

    def type_of_scalar(self, size_int: int) -> int:
        return int(self.type_of(np.array([size_int]))[0])

    def effective_size(self, sizes_int: np.ndarray) -> np.ndarray:
        """Size used for occupancy: actual size, except the last VQ rounds UP
        to 1/2^J (paper Section V.A)."""
        s = np.asarray(sizes_int, dtype=np.int64)
        return np.where(s <= self.min_grid_size, self.min_grid_size, s)

    def upper_bound_int(self, type_idx: int) -> int:
        """sup I_j on the grid (upper-rounded VQ size)."""
        m, odd = divmod(int(type_idx), 2)
        if odd == 0:
            return RES >> m
        # the largest grid value classified into I_{2m+1} satisfies
        # 3*s <= 2*(RES>>m), i.e. floor division
        return (2 * (RES >> m)) // 3

    def interval(self, type_idx: int) -> tuple[float, float]:
        """(inf, sup] of I_j in floats, for reporting."""
        m, odd = divmod(int(type_idx), 2)
        if odd == 0:
            return (2.0 / 3.0 * 0.5**m, 0.5**m)
        return (0.5 ** (m + 1), 2.0 / 3.0 * 0.5**m)


@lru_cache(maxsize=32)
def k_red(J: int) -> np.ndarray:
    """The reduced configuration set K_RED^(J): array (4J-4, 2J) of ints.

    Rows (paper Eq. 7):
        2^m e_{2m},                      m = 0..J-1
        3*2^{m-1} e_{2m+1},              m = 1..J-1
        e_1 + floor(2^m / 3) e_{2m},     m = 2..J-1
        e_1 + 2^{m-1} e_{2m+1},          m = 1..J-1
    """
    if J < 2:
        raise ValueError("J >= 2")
    n = 2 * J
    rows = []
    for m in range(J):
        v = np.zeros(n, dtype=np.int64)
        v[2 * m] = 1 << m
        rows.append(v)
    for m in range(1, J):
        v = np.zeros(n, dtype=np.int64)
        v[2 * m + 1] = 3 * (1 << (m - 1))
        rows.append(v)
    for m in range(2, J):
        v = np.zeros(n, dtype=np.int64)
        v[1] = 1
        v[2 * m] = (1 << m) // 3
        rows.append(v)
    for m in range(1, J):
        v = np.zeros(n, dtype=np.int64)
        v[1] = 1
        v[2 * m + 1] = 1 << (m - 1)
        rows.append(v)
    out = np.stack(rows)
    if out.shape != (4 * J - 4, 2 * J):
        raise AssertionError(f"k_red({J}) has shape {out.shape}")
    return out


def k_red_is_feasible(J: int) -> bool:
    """Sanity check: every configuration packs within capacity when each
    type-j job takes its upper-rounded size sup I_j."""
    part = PartitionI(J)
    confs = k_red(J)
    uppers = np.array([part.upper_bound_int(j) for j in range(2 * J)])
    tot = confs @ uppers
    # +J: integer rounding slack of the 2/3 bounds
    return bool(np.all(tot <= RES + J))


def max_weight_config(J: int, vq_sizes: np.ndarray) -> tuple[int, np.ndarray]:
    """argmax_{k in K_RED} <k, Q> (paper Eq. 8). Returns (row index, config)."""
    confs = k_red(J)
    w = confs @ np.asarray(vq_sizes, dtype=np.int64)
    i = int(np.argmax(w))
    return i, confs[i]
