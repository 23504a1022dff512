"""ctypes wrapper of the Best-Fit placement kernel (``csrc/best_fit.cu``).

For CUDA tensors :func:`best_fit_cuda` launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.best_fit_ref_batched``.
``launches`` counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import LaunchCounter
from .ref import best_fit_ref_batched

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("best_fit")
    lib.best_fit_launch.restype = ctypes.c_int
    lib.best_fit_launch.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P]
    return lib


def best_fit_cuda(residuals: torch.Tensor, sizes: torch.Tensor):
    """Batched sequential Best-Fit: residuals (G, L) f32, sizes (G, N) f32
    -> (assignment (G, N) int32, -1 = rejected; new residuals (G, L)).
    One thread block per problem."""
    if residuals.ndim != 2 or sizes.ndim != 2 \
            or sizes.shape[0] != residuals.shape[0]:
        raise ValueError(f"residuals must be (G, L) and sizes (G, N), got "
                         f"{tuple(residuals.shape)} and {tuple(sizes.shape)}")
    if residuals.dtype != torch.float32 or sizes.dtype != torch.float32:
        raise ValueError("residuals and sizes must be float32")
    if sizes.device != residuals.device:
        raise ValueError(f"sizes on {sizes.device}, residuals on "
                         f"{residuals.device}")
    if residuals.device.type == "cpu":
        return best_fit_ref_batched(residuals, sizes)
    if residuals.device.type != "cuda":
        raise ValueError(f"best_fit kernel runs on CUDA tensors, got "
                         f"{residuals.device}")
    residuals, sizes = residuals.contiguous(), sizes.contiguous()
    G, L = residuals.shape
    N = sizes.shape[1]
    assign = torch.empty((G, N), dtype=torch.int32, device=residuals.device)
    out = torch.empty_like(residuals)
    if G == 0:
        return assign, out
    lib = _lib()
    with torch.cuda.device(residuals.device):
        stream = torch.cuda.current_stream(residuals.device).cuda_stream
        err = lib.best_fit_launch(residuals.data_ptr(), sizes.data_ptr(),
                                  G, L, N, assign.data_ptr(), out.data_ptr(),
                                  stream)
    build.check(lib, err, "best_fit kernel launch")
    launches.count += 1
    return assign, out
