"""ctypes wrapper of the decode-attention kernel
(``csrc/decode_attention.cu``).

For CUDA tensors :func:`decode_attention_cuda` launches the kernel (or
raises); for CPU tensors it runs the plain version,
``ref.decode_attention_ref``.  ``launches`` counts kernel launches only:
one per call, the split over the cache and its merge being one launch.

The launch's grid depends on the shapes only (the cluster size comes
from B, H, KV and C) and the kernel reads ``pos`` on the device, so a call
on a (B,) int32 CUDA ``pos`` can be captured in a CUDA graph and replayed
after ``pos`` changes in place."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import SMEM_LIMIT_BYTES, LaunchCounter
from .ref import decode_attention_ref, row_positions

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim the kernel takes (32 lanes of 16 elements share a row).
MAX_HEAD_DIM = 512


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, ctypes.c_float, _I,
                                            _P]
    lib.decode_attention_shared_bytes.restype = ctypes.c_longlong
    lib.decode_attention_shared_bytes.argtypes = [_I, _I]
    lib.decode_attention_cluster_size.restype = ctypes.c_int
    lib.decode_attention_cluster_size.argtypes = [_I, _I, _I, _I]
    return lib


def cluster_size(B: int, H: int, KV: int, C: int) -> int:
    """Thread blocks that split the cache of each (row, kv head, group of
    4 query heads) in a launch of this shape (builds the kernel)."""
    return _lib().decode_attention_cluster_size(B, H, KV, C)


def check_inputs(q, k, v) -> None:
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, hd) and k, v (B, KV, C, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} "
                         "disagree (batch, head dim, or H % KV != 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def decode_attention_cuda(q, k, v, pos, *, window: int = 0) -> torch.Tensor:
    """One-token GQA decode: q (B, H, hd), cache k, v (B, KV, C, hd), pos
    (B,) int32 (or a scalar for every row) -> (B, H, hd) in q's dtype.  One
    cluster of thread blocks per (row, kv head, group of 4 query heads),
    splitting its valid rows and merging them in the same launch."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    B, H, hd = q.shape
    KV, C = k.shape[1], k.shape[2]
    if hd * q.element_size() % 16:
        raise NotImplementedError(
            f"decode_attention kernel reads the cache in 16-byte vectors: "
            f"hd * {q.element_size()} bytes must be a multiple of 16, got "
            f"hd={hd}")
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"decode_attention kernel takes hd <= "
                                  f"{MAX_HEAD_DIM}, got {hd}")
    pos = row_positions(pos, B, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # a view into the middle of a storage may start off the 16-byte grid
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    lib = _lib()
    smem = lib.decode_attention_shared_bytes(hd, q.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"decode_attention kernel needs {smem} bytes of shared memory "
            f"for hd={hd}, over the {SMEM_LIMIT_BYTES}-byte limit")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, H, KV, C, hd, int(window), float(hd**-0.5),
            int(q.dtype == torch.bfloat16), stream)
    build.check(lib, err, "decode_attention kernel launch")
    launches.count += 1
    return out
