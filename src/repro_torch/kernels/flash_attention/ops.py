"""Public entry point of the flash-attention kernels: the forward kernel
with its hand-written backward for CUDA tensors, the plain version under
native autograd for CPU tensors (or on request)."""
from __future__ import annotations

from .flash_attention import flash_attention_cuda
from .ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              use_kernel: bool = True):
    """q (B, H, Sq, hd); k (B, KV, Sk, hd); v (B, KV, Sk, hd_v), hd_v <= hd;
    returns (B, H, Sq, hd_v), differentiable in q, k and v.  On CUDA
    tensors it goes through ``flash_attention.FlashAttention`` (the forward
    kernel, then the two backward kernels); ``use_kernel=False`` runs the
    plain version on any device (the JAX entry point's
    ``use_pallas=False``)."""
    if use_kernel:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
