"""ctypes wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``).

For CUDA tensors :func:`flash_attention_cuda` launches the kernel (or
raises); for CPU tensors it runs the plain version, ``ref.attention_ref``.
``launches`` counts kernel launches only.

Which instance a CUDA call runs is a dispatch on dtype and width
(:func:`instance`): bf16 with hd <= 128 always runs the tensor-core
instance (wgmma fed by TMA, read and written through the tensors'
strides); float32, and any hd > 128, run the CUDA-core instance in float32
arithmetic on contiguous tensors."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build
from ..common import LaunchCounter
from .ref import attention_ref

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim the kernel takes (its largest padded-width instance).
MAX_HEAD_DIM = 256
#: Largest head dim of the bf16 tensor-core instance.
TC_MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _I, _I, ctypes.c_float,
                                           _I, _P]
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_tc_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _I, _P, _I, _I,
                                              ctypes.c_float, _P]
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


def instance(dtype: torch.dtype, hd: int) -> str:
    """The kernel instance a CUDA call of this dtype and head dim runs:
    ``"tensor-core"`` for bf16 with hd <= 128, else ``"cuda-core"``."""
    return ("tensor-core" if dtype == torch.bfloat16
            and hd <= TC_MAX_HEAD_DIM else "cuda-core")


def _strides(x) -> list[int]:
    """(row, head, batch) strides of a (B, heads, rows, hd) tensor in
    elements, as the TMA maps take them; a dim of extent 1 is never
    stepped, so it gets hd's stride."""
    return [x.stride(d) if x.shape[d] > 1 else x.shape[3] for d in (2, 1, 0)]


def _tma_ready(x):
    """``x`` itself when TMA can read it through its strides (hd
    contiguous, the other strides whole 16-byte steps, a 16-byte aligned
    start), else a contiguous copy."""
    if x.stride(3) == 1 and x.data_ptr() % 16 == 0 \
            and all(s % 8 == 0 for s in _strides(x)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _tensor_core(lib, q, k, v, causal: bool, window: int):
    """The bf16 instance: reads q, k, v and writes out through their
    strides; hd not a multiple of 8 is zero-padded to one (TMA reads rows
    in 16-byte steps), which adds exact zeros to every dot."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = float(hd**-0.5)
    pad = -hd % 8
    if pad:
        q, k, v = (F.pad(x, (0, pad)) for x in (q, k, v))
    q, k, v = (_tma_ready(x) for x in (q, k, v))
    out = torch.empty_like(q)           # q's strides: a view's, kept
    strides = (ctypes.c_longlong * 12)(*(_strides(q) + _strides(k)
                                         + _strides(v) + _strides(out)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, hd + pad, strides, int(causal), int(window), scale, stream)
    build.check(lib, err, "flash_attention tensor-core kernel launch")
    return out[..., :hd] if pad else out


def _cuda_core(lib, q, k, v, causal: bool, window: int):
    """The float32-arithmetic instance on contiguous tensors."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B * H > 65535:
        raise NotImplementedError(f"flash_attention CUDA-core kernel takes "
                                  f"B * H <= 65535, got {B * H}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, hd, int(causal), int(window), float(hd**-0.5),
        int(q.dtype == torch.bfloat16), stream)
    build.check(lib, err, "flash_attention kernel launch")
    return out


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA forward: q (B, H, Sq, hd), k, v
    (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's dtype.  On CUDA, bf16 with
    hd <= 128 runs the tensor-core instance and returns a tensor with q's
    strides (so the model's (B, S, H, hd) views need no copy in or out);
    float32 and wider heads run the CUDA-core instance."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    hd, Sk = q.shape[3], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attention kernel takes hd <= "
                                  f"{MAX_HEAD_DIM}, got {hd}")
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q)
    lib = _lib()
    run = _tensor_core if instance(q.dtype, hd) == "tensor-core" \
        else _cuda_core
    with torch.cuda.device(q.device):
        out = run(lib, q, k, v, causal, window)
    launches.count += 1
    return out
