"""ctypes wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``).

For CUDA tensors :func:`flash_attention_cuda` launches the kernel (or
raises); for CPU tensors it runs the plain version, ``ref.attention_ref``.
``launches`` counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import LaunchCounter
from .ref import attention_ref

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim the kernel takes (its largest padded-width instance).
MAX_HEAD_DIM = 256


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _I, _I, ctypes.c_float,
                                           _I, _P]
    return lib


def check_inputs(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, hd) and k, v (B, KV, Sk, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree (batch, head dim, or H % KV != 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA forward: q (B, H, Sq, hd), k, v
    (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's dtype.  One thread block per
    (b, h, 64-query tile)."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attention kernel takes hd <= "
                                  f"{MAX_HEAD_DIM}, got {hd}")
    if B * H > 65535:
        raise NotImplementedError(f"flash_attention kernel takes B * H <= "
                                  f"65535, got {B * H}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KV, Sq, Sk, hd, int(causal), int(window), float(hd**-0.5),
            int(q.dtype == torch.bfloat16), stream)
    build.check(lib, err, "flash_attention kernel launch")
    launches.count += 1
    return out
