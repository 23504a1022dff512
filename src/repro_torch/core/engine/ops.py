"""Primitive scheduling ops shared by the engines (torch port of
``repro.core.engine.ops``: the BF-J/S ops, the VQS classifier and
configuration table, and the exact Tetris alignment score).

Every op takes any number of leading batch axes — the ensemble axis that
the JAX package adds with ``vmap``.  Ties always break to the lowest index.
"""
from __future__ import annotations

import torch

from ..partition import k_red
from ..quantize import RES


def row_sum_lr(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as an explicit left-to-right float32 chain,
    ``((x0 + x1) + x2) + ...``.

    Feasibility decisions compare residuals ``1 - row.sum()`` exactly, so
    the summation order decides placements.  XLA's float32 row sum on the
    CPU runs left to right for the row widths the engines use, while
    ``torch.sum`` reduces in another order; spelling the chain out makes the
    port's residuals bit-equal to the JAX package's, and the CUDA kernels
    use the same chain."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def best_fit_server(residuals: torch.Tensor,
                    size: torch.Tensor) -> torch.Tensor:
    """Tightest feasible server for one job: argmin residual among residuals
    >= size; -1 if none fits.  ``residuals (..., L)``, ``size (...)``."""
    feasible = residuals >= size[..., None]
    masked = torch.where(feasible, residuals,
                         torch.full_like(residuals, float("inf")))
    idx = torch.argmin(masked, dim=-1)
    return torch.where(feasible.any(-1), idx, -1)


def best_fit_place(residuals: torch.Tensor, sizes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequentially Best-Fit place a batch of jobs: ``residuals (..., L)``,
    ``sizes (..., N)`` -> (assignment ``(..., N)`` int32 with -1 =
    rejected, new residuals)."""
    resid = residuals.clone()
    assign = []
    for i in range(sizes.shape[-1]):
        size = sizes[..., i]
        srv = best_fit_server(resid, size)
        ok = srv >= 0
        col = torch.clamp_min(srv, 0)[..., None]
        cur = torch.gather(resid, -1, col)[..., 0]
        resid.scatter_(-1, col, torch.where(ok, cur + (-size), cur)[..., None])
        assign.append(srv)
    return torch.stack(assign, dim=-1).to(torch.int32), resid


def alignment_score_pair(avail: torch.Tensor, demand: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tetris alignment ``<demand, avail>`` per server (paper §VIII), exact.

    ``avail`` is ``(..., L, R)`` grid-integer availability and ``demand``
    ``(..., R)`` grid integers.  The score needs up to ~34 bits, too wide
    for int32 and for a float32 mantissa, and a float score is not
    portable (a compiler may contract the mul+add into an FMA in one
    lowering and not another, which flips argmin tie-breaks).  So, as the
    JAX ``alignment_score_pair_jnp``, the score is an int32 pair ``(hi,
    lo)`` with ``score == hi * 256 + lo`` and ``0 <= lo < 256``: each
    product is taken against the split demand ``(d >> 8, d & 255)`` and
    stays below 2**24, so every operation is exact, and comparing ``(hi,
    lo)`` lexicographically compares the exact scores.  Exact while ``R *
    capacity`` stays under ~128 server capacities."""
    a = avail.to(torch.int32)
    d = demand.to(torch.int32)[..., None, :]
    hi = a[..., 0] * (d[..., 0] >> 8)
    lo = a[..., 0] * (d[..., 0] & 255)
    for r in range(1, a.shape[-1]):
        hi = hi + a[..., r] * (d[..., r] >> 8)
        lo = lo + a[..., r] * (d[..., r] & 255)
    return hi + (lo >> 8), lo & 255


def first_empty_positions(empty: torch.Tensor, want: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter targets for admitting a masked batch into a fixed buffer.

    ``empty`` is the buffer's ``(..., Q)`` empty-slot mask, ``want`` a
    ``(..., N)`` mask of items asking for a slot.  Returns ``(pos,
    landed)``: the i-th wanting item (in index order) is assigned the i-th
    empty slot, ``landed`` masks the items that actually got one (``pos <
    Q``; entries of non-wanting items are garbage and must stay masked)."""
    n_empty = torch.cumsum(empty.to(torch.int32), dim=-1).contiguous()
    rank = torch.cumsum(want.to(torch.int32), dim=-1) - 1
    pos = torch.searchsorted(n_empty, (rank + 1).to(n_empty.dtype).contiguous())
    return pos, want & (pos < empty.shape[-1])


def largest_fitting_job(queue: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Index of the largest queued job with size <= cap (BF-S step); -1 if
    none.  Zero entries are empty queue slots.  ``queue (..., Q)``,
    ``cap (...)``."""
    fits = (queue > 0) & (queue <= cap[..., None])
    masked = torch.where(fits, queue, torch.full_like(queue, float("-inf")))
    idx = torch.argmax(masked, dim=-1)
    return torch.where(fits.any(-1), idx, -1)


def k_red_t(J: int, device=None) -> torch.Tensor:
    """The reduced configuration set K_RED^(J) as an ``(4J-4, 2J)`` int32
    tensor on ``device`` (``partition.k_red`` itself is lru-cached)."""
    return torch.as_tensor(k_red(J), dtype=torch.int32, device=device)


def max_weight_config(confs: torch.Tensor, vq_sizes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """argmax over the rows of ``confs`` of ``<k, Q>`` (paper Eq. 8) with
    ``np.argmax`` ties (the first maximal row).  ``vq_sizes (..., 2J)``
    -> (row index ``(...)`` int64, row ``(..., 2J)`` int32)."""
    w = (confs * vq_sizes.to(torch.int32)[..., None, :]).sum(
        -1, dtype=torch.int32)
    c_iota = torch.arange(confs.shape[0], device=confs.device)
    i = torch.where(w == w.amax(-1, keepdim=True), c_iota,
                    confs.shape[0]).amin(-1)
    return i, confs[i]


def vq_type_of_grid(g: torch.Tensor, J: int) -> torch.Tensor:
    """Partition-I type of integer grid sizes (exact).

    Comparison for comparison the JAX ``vq_type_of_grid``: ``m = #{k in
    1..J : g <= RES >> k}`` clipped to ``J-1``, even/odd split by ``3g >
    2*(RES >> m)``, and the ``g <= RES >> J`` tail mapping to the last
    type ``2J - 1``."""
    g = g.to(torch.int32)
    bounds = torch.tensor([RES >> k for k in range(1, J + 1)],
                          dtype=torch.int32, device=g.device)
    m = torch.clamp_max((g[..., None] <= bounds).sum(-1, dtype=torch.int32),
                        J - 1)
    upper = torch.full_like(m, RES) >> m
    t = torch.where(3 * g > 2 * upper, 2 * m, 2 * m + 1)
    return torch.where(g <= (RES >> J), 2 * J - 1, t).to(torch.int32)


def to_grid_t(sizes: torch.Tensor) -> torch.Tensor:
    """Float sizes to the integer grid, ``max(round(size * RES), 1)`` in
    float32 (round half to even), as the engines quantize in-loop."""
    return torch.clamp_min(torch.round(sizes * RES), 1.0).to(torch.int32)


def vq_type_of(sizes: torch.Tensor, J: int) -> torch.Tensor:
    """Partition-I type of float sizes in (0, 1]: quantized with
    :func:`to_grid_t`, then classified by the exact integer rule."""
    return vq_type_of_grid(to_grid_t(sizes), J)
