"""Public entry points of the Best-Fit kernel: the kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from .best_fit import best_fit_cuda


def best_fit(residuals, sizes):
    """Single problem: residuals (L,) f32, sizes (N,) f32."""
    assign, r = best_fit_cuda(residuals[None], sizes[None])
    return assign[0], r[0]


def best_fit_batched(residuals, sizes):
    """G independent problems: residuals (G, L), sizes (G, N)."""
    return best_fit_cuda(residuals, sizes)
