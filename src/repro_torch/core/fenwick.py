"""Fenwick (binary indexed) tree over a fixed integer key range.

Used as an exact multiset over quantized job sizes / server residuals with
O(log n):
  * add/remove of a key,
  * ``count_leq(x)`` prefix counts,
  * ``max_leq(x)``: largest present key <= x   (Best-Fit "largest fitting job"),
  * ``min_geq(x)``: smallest present key >= x  (Best-Fit "tightest server").

Keys are ints in [0, size).  The descend operations exploit the implicit
binary structure of the tree, so no per-query scans over the key range.

Copied from ``repro.core.fenwick``: host numpy, equal to it
bit for bit (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import numpy as np


class Fenwick:
    __slots__ = ("n", "_pow", "tree", "total")

    def __init__(self, size: int):
        self.n = int(size)
        self._pow = 1 << (self.n.bit_length() - (0 if self.n & (self.n - 1) else 1))
        if self._pow < self.n:
            self._pow <<= 1
        self.tree = np.zeros(self.n + 1, dtype=np.int64)
        self.total = 0

    def add(self, key: int, delta: int = 1) -> None:
        i = key + 1
        t = self.tree
        while i <= self.n:
            t[i] += delta
            i += i & (-i)
        self.total += delta

    def count_leq(self, key: int) -> int:
        """Number of stored items with value <= key."""
        if key < 0:
            return 0
        i = min(key + 1, self.n)
        s = 0
        t = self.tree
        while i > 0:
            s += t[i]
            i -= i & (-i)
        return int(s)

    def kth(self, k: int) -> int:
        """Smallest key such that count_leq(key) >= k (1-indexed k)."""
        pos = 0
        rem = k
        half = self._pow
        t = self.tree
        n = self.n
        while half > 0:
            nxt = pos + half
            if nxt <= n and t[nxt] < rem:
                pos = nxt
                rem -= t[nxt]
            half >>= 1
        return pos  # 0-indexed key

    def max_leq(self, key: int) -> int:
        """Largest present key <= key, or -1 if none."""
        c = self.count_leq(key)
        if c == 0:
            return -1
        return self.kth(c)

    def min_geq(self, key: int) -> int:
        """Smallest present key >= key, or -1 if none."""
        below = self.count_leq(key - 1)
        if below >= self.total:
            return -1
        return self.kth(below + 1)


class SegTreeMax:
    """Segment tree over server indices storing max residual capacity.

    Supports ``first_fit(size)``: the smallest server index whose residual is
    >= size (First-Fit), in O(log L); and point updates.
    """

    __slots__ = ("n", "size", "tree")

    def __init__(self, values: np.ndarray):
        self.n = len(values)
        size = 1
        while size < self.n:
            size <<= 1
        self.size = size
        self.tree = np.zeros(2 * size, dtype=np.int64)
        self.tree[size : size + self.n] = values
        for i in range(size - 1, 0, -1):
            self.tree[i] = max(self.tree[2 * i], self.tree[2 * i + 1])

    def update(self, idx: int, value: int) -> None:
        i = idx + self.size
        t = self.tree
        t[i] = value
        i >>= 1
        while i:
            v = max(t[2 * i], t[2 * i + 1])
            if t[i] == v:
                break
            t[i] = v
            i >>= 1

    def get(self, idx: int) -> int:
        return int(self.tree[idx + self.size])

    def first_fit(self, size: int) -> int:
        """Smallest index with value >= size, or -1."""
        t = self.tree
        if t[1] < size:
            return -1
        i = 1
        while i < self.size:
            i <<= 1
            if t[i] < size:
                i |= 1
        idx = i - self.size
        return idx if idx < self.n else -1
