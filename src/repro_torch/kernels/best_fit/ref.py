"""Plain PyTorch version of the Best-Fit placement kernel."""
from __future__ import annotations

import torch

from ..common import BIG


def best_fit_ref_batched(residuals: torch.Tensor, sizes: torch.Tensor):
    """Sequential Best-Fit over G independent problems: residuals (G, L),
    sizes (G, N) -> (assignment (G, N) int32, -1 = rejected; new residuals
    (G, L)).  Each job goes to the feasible server with least residual,
    lowest index on ties, and is rejected when nothing fits or its size is
    <= 0 — the arithmetic of the kernel, step for step."""
    G, L = residuals.shape
    r = residuals.clone()
    lane = torch.arange(L, device=r.device)
    big = torch.tensor(BIG, dtype=r.dtype, device=r.device)
    assign = torch.empty(sizes.shape, dtype=torch.int32, device=r.device)
    for j in range(sizes.shape[1]):
        size = sizes[:, j:j + 1]
        feasible = r >= size
        masked = torch.where(feasible, r, big)
        best = masked.amin(1, keepdim=True)
        srv = torch.where((masked == best) & feasible, lane, L).amin(1)
        ok = (srv < L) & (size[:, 0] > 0)
        take = ok[:, None] & (lane == srv[:, None])
        r = torch.where(take, r - size, r)
        assign[:, j] = torch.where(ok, srv, -1)
    return assign, r


def best_fit_ref(residuals: torch.Tensor, sizes: torch.Tensor):
    """Single problem: residuals (L,), sizes (N,)."""
    assign, r = best_fit_ref_batched(residuals[None], sizes[None])
    return assign[0], r[0]
