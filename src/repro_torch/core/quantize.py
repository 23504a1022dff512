"""Integer size grid (copy of ``repro.core.quantize``).

All capacity arithmetic of the event-driven engine and the VQS engines is
exact integer math on a ``RES = 2**16`` grid: a job of normalized size ``r``
occupies ``round(r * RES)`` units of a server whose capacity is
``capacity * RES`` units.
"""
from __future__ import annotations

import numpy as np

RES: int = 1 << 16  # grid resolution (server capacity == 1.0 == RES units)

# 2/3 of a unit server, used by the VQS reservation rule.  round(2/3 * RES).
TWO_THIRDS: int = (2 * RES + 1) // 3  # 43691


def to_grid(sizes) -> np.ndarray:
    """Quantize float sizes in (0, 1] to the integer grid (>= 1)."""
    arr = np.asarray(sizes, dtype=np.float64)
    q = np.rint(arr * RES).astype(np.int64)
    return np.maximum(q, 1)


def from_grid(sizes_int) -> np.ndarray:
    return np.asarray(sizes_int, dtype=np.float64) / RES
