"""Public entry point of the flash-attention kernel: the kernel for CUDA
tensors, its plain version for CPU tensors (or on request)."""
from __future__ import annotations

from .flash_attention import flash_attention_cuda
from .ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              use_kernel: bool = True):
    """q (B, H, Sq, hd); k, v (B, KV, Sk, hd).  ``use_kernel=False`` runs
    the plain version on any device (the JAX entry point's
    ``use_pallas=False``)."""
    if use_kernel:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
