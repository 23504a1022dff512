"""GQA attention (the port of ``repro.models.attention``): the full-sequence
path through the flash-attention kernel and the one-token decode path,
over a linear or (with a sliding window) ring KV cache, through the
decode-attention kernel.

The KV cache is kept in the kernels' layout, ``(B, KV, C, hd)``, so no step
transposes it (the JAX layout is ``(B, C, KV, hd)``; ``repro_torch.convert``
moves between the two).  Decode writes the cache in place and takes one
position per row: the JAX serving engine's ``vmap`` over requests written
as one batched call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.decode_attention.ops import decode_attn
from ..kernels.flash_attention.ops import attention
from .config import ModelConfig
from .layers import cdtype, dense_init, rotate


def attn_init(cfg: ModelConfig, generator, device, dtype) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {name: dense_init(shape, generator, device).to(dtype)
         for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                             ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(n, dtype=dtype, device=device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, KV, C, hd)
    v: torch.Tensor       # (B, KV, C, hd)
    length: torch.Tensor  # () int32: last position written + 1 (max over rows)


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                  dtype=None) -> KVCache:
    C = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype or cdtype(cfg)
    return KVCache(
        k=torch.zeros((batch, KV, C, hd), dtype=dt, device=device),
        v=torch.zeros((batch, KV, C, hd), dtype=dt, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def _qkv(params, x: torch.Tensor, cfg: ModelConfig):
    dt = cdtype(cfg)
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def attn_apply(params, x: torch.Tensor, rope, cfg: ModelConfig, *,
               use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill): x (B, S, D);
    rope: ``layers.rope_tables`` of the (B, S) positions."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q, k = rotate(q, *rope), rotate(k, *rope)
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=True, window=cfg.sliding_window,
                    use_kernel=use_kernels)                   # (B, H, S, hd)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ params["wo"].to(cdtype(cfg))


def attn_decode(params, x: torch.Tensor, pos: torch.Tensor, rope,
                cache: KVCache, cfg: ModelConfig, *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: (B, 1, D); pos: (B,) int32, each row's absolute
    position; rope: ``layers.rope_tables`` of ``pos`` as (B, 1).  Writes
    row b's k and v at cache slot ``pos[b] % C`` in place and attends over
    slots ``0..min(pos[b], C - 1)``.

    With a sliding window the cache is a ring of ``C = min(cache_len,
    window)`` slots.  JAX masks each slot by the position stored in it
    (valid when >= 0 and inside the window); since ``C <= window`` that is
    exactly ``slot <= pos``: the slots ``0..pos`` before the ring wraps,
    every slot after.  Softmax does not depend on the slots' order, so the
    kernel runs with ``window=0`` and the absolute ``pos``.  Its own
    window test compares slot indices with absolute positions, which on a
    wrapped ring would mask valid slots."""
    B = x.shape[0]
    C = cache.k.shape[2]
    q, k, v = _qkv(params, x, cfg)
    q, k = rotate(q, *rope), rotate(k, *rope)

    slot = (pos % C).long()
    batch = torch.arange(B, device=x.device)
    cache.k[batch, :, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[batch, :, slot] = v[:, 0].to(cache.v.dtype)
    cache = KVCache(cache.k, cache.v, (pos.max() + 1).to(torch.int32))

    # window=0 on a ring too: "slot <= pos" is the ring's mask (docstring)
    o = decode_attn(q[:, 0], cache.k, cache.v, pos, window=0,
                    use_kernel=use_kernels)                   # (B, H, hd)
    o = o.reshape(B, 1, -1).to(cdtype(cfg))
    return o @ params["wo"].to(cdtype(cfg)), cache
