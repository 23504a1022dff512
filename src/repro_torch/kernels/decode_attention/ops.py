"""Public entry point of the decode-attention kernel: the kernel for CUDA
tensors, its plain version for CPU tensors (or on request)."""
from __future__ import annotations

from .decode_attention import decode_attention_cuda
from .ref import decode_attention_ref


def decode_attn(q, k, v, pos, *, window: int = 0, use_kernel: bool = True):
    """q (B, H, hd); k, v (B, KV, C, hd); pos (B,) int32 or a scalar.
    ``use_kernel=False`` runs the plain version on any device (the JAX
    entry point's ``use_pallas=False``)."""
    if use_kernel:
        return decode_attention_cuda(q, k, v, pos, window=window)
    return decode_attention_ref(q, k, v, pos, window=window)
