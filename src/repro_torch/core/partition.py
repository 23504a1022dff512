"""The reduced configuration set K_RED^(J) of the paper (Eq. 7,
Definition 5), copied from ``repro.core.partition``.

Partition I of (1/2^J, 1] into 2J subintervals (m = 0..J-1):
    I_{2m}   = (2/3 * 2^-m , 2^-m]          "even" types
    I_{2m+1} = (1/2 * 2^-m , 2/3 * 2^-m]    "odd"  types
Jobs with size <= 2^-J map to the last type (2J-1).  The classifier on the
integer grid is ``core.engine.ops.vq_type_of_grid``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


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
