"""Multi-head Latent Attention, DeepSeek-V2 (the port of
``repro.models.mla``): the KV cache is a compressed latent ``c_kv``
(``kv_lora_rank``) plus one rotary key (``qk_rope_dim``) per token, shared
by every head.

Prefill decompresses K and V for the sequence and runs the flash-attention
kernel with q and k ``nope || rope`` wide (192 for deepseek-v2-lite) and v
at its own width (128).  Decode writes the latent row of each batch row in
place and, by default, decompresses the whole latent cache into K and V
and runs the decode-attention kernel with one query head per KV head.
``cfg.mla_absorb`` folds ``w_uk`` into the query and ``w_uv`` into the
output instead and attends against the latent itself, in plain float32
einsums as the JAX package does (its latent key, ``kv_lora_rank +
qk_rope_dim`` = 576 wide, is past the decode kernel's widest head).

The cache keeps the JAX layout, ``(B, C, r)`` and ``(B, C, rd)``: it is
linear, not a ring.  A row at ``pos >= C`` writes the last slot, where JAX's
``dynamic_update_slice`` clamps the start.  The scale is ``(qk_nope_dim +
qk_rope_dim) ** -0.5``, the kernels' ``hd ** -0.5`` of the 192-wide keys.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.decode_attention.ops import decode_attn
from ..kernels.flash_attention.ops import attention
from .config import ModelConfig
from .layers import cdtype, dense_init, rotate

NEG_INF = -1e30


def mla_init(cfg: ModelConfig, generator, device, dtype) -> dict:
    """The JAX ``mla_init`` laws; the bits differ from threefry's.  JAX
    draws ``w_uk`` and ``w_uv`` from one key, so they are equal when
    ``qk_nope_dim == v_head_dim``; the port keeps that."""
    D, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim

    def draw(shape):
        return dense_init(shape, generator, device).to(dtype)
    p = {"wq": draw((D, H * qd)), "w_dkv": draw((D, r)),
         "w_kr": draw((D, cfg.qk_rope_dim)),
         "w_uk": draw((r, H * cfg.qk_nope_dim))}
    p["w_uv"] = p["w_uk"].clone() if cfg.qk_nope_dim == cfg.v_head_dim \
        else draw((r, H * cfg.v_head_dim))
    p["wo"] = draw((H * cfg.v_head_dim, D))
    return p


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, C, kv_lora_rank)
    k_rope: torch.Tensor  # (B, C, qk_rope_dim)
    length: torch.Tensor  # () int32: last position written + 1 (max over rows)


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                   dtype=None) -> MLACache:
    dt = dtype or cdtype(cfg)
    return MLACache(
        c_kv=torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dt,
                         device=device),
        k_rope=torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dt,
                           device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def _project_qkv(params, x: torch.Tensor, rope, cfg: ModelConfig):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rd), c_kv (B, S, r), k_rope
    (B, S, rd); rope: ``layers.rope_tables`` at ``qk_rope_dim``."""
    dt = cdtype(cfg)
    B, S, _ = x.shape
    q = (x @ params["wq"].to(dt)).reshape(B, S, cfg.num_heads, -1)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = rotate(q_rope, *rope)
    c_kv = x @ params["w_dkv"].to(dt)
    k_rope = rotate((x @ params["w_kr"].to(dt))[:, :, None], *rope)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _decompress(params, c_kv: torch.Tensor, cfg: ModelConfig):
    """k_nope (B, S, H, nope) and v (B, S, H, v_head_dim) from the latent."""
    dt = c_kv.dtype
    B, S, _ = c_kv.shape
    H = cfg.num_heads
    k_nope = (c_kv @ params["w_uk"].to(dt)).reshape(B, S, H, cfg.qk_nope_dim)
    v = (c_kv @ params["w_uv"].to(dt)).reshape(B, S, H, cfg.v_head_dim)
    return k_nope, v


def _keys(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """(B, H, S, nope + rd), contiguous: each head's key with the shared
    rotary key."""
    B, S, H, _ = k_nope.shape
    return torch.cat([k_nope.transpose(1, 2),
                      k_rope[:, None].expand(B, H, S, -1)], dim=-1)


def mla_apply(params, x: torch.Tensor, rope, cfg: ModelConfig, *,
              use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal MLA (train / prefill): x (B, S, D); rope: the
    positions' tables at ``qk_rope_dim``."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, rope, cfg)
    k_nope, v = _decompress(params, c_kv, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(q.transpose(1, 2), _keys(k_nope, k_rope),
                    v.transpose(1, 2), causal=True,
                    use_kernel=use_kernels)                 # (B, H, S, vd)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ params["wo"].to(cdtype(cfg))


def mla_decode(params, x: torch.Tensor, pos: torch.Tensor, rope,
               cache: MLACache, cfg: ModelConfig, *, use_kernels: bool = True
               ) -> tuple[torch.Tensor, MLACache]:
    """One-token decode against the compressed cache.  x: (B, 1, D); pos:
    (B,) int32, each row's absolute position; rope: the tables of ``pos``
    as (B, 1).  Writes row b's latent at slot ``min(pos[b], C - 1)`` in
    place and attends over slots ``0..min(pos[b], C - 1)``."""
    dt = cdtype(cfg)
    B = x.shape[0]
    H, C = cfg.num_heads, cache.c_kv.shape[1]
    q_nope, q_rope, c_new, kr_new = _project_qkv(params, x, rope, cfg)

    slot = pos.clamp_max(C - 1).long()
    batch = torch.arange(B, device=x.device)
    cache.c_kv[batch, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[batch, slot] = kr_new[:, 0].to(cache.k_rope.dtype)
    cache = MLACache(cache.c_kv, cache.k_rope,
                     (pos.max() + 1).to(torch.int32))

    if cfg.mla_absorb:
        o = _absorbed(params, q_nope[:, 0], q_rope[:, 0], pos, cache, cfg)
    else:
        # the whole cache decompressed into (B, H, C, nope + rd) keys and
        # (B, H, C, vd) values: one query head per KV head
        k_nope, v = _decompress(params, cache.c_kv, cfg)
        q = torch.cat([q_nope, q_rope], dim=-1)[:, 0]       # (B, H, qd)
        o = decode_attn(q, _keys(k_nope, cache.k_rope), v.transpose(1, 2),
                        pos, window=0, use_kernel=use_kernels)  # (B, H, vd)
    o = o.reshape(B, 1, H * cfg.v_head_dim).to(dt)
    return o @ params["wo"].to(dt), cache


def _absorbed(params, q_nope, q_rope, pos, cache: MLACache,
              cfg: ModelConfig) -> torch.Tensor:
    """Attention against the latent (B, H, vd), in float32: ``w_uk`` folded
    into the query, ``w_uv`` into the output (the JAX einsums)."""
    H, r, C = cfg.num_heads, cfg.kv_lora_rank, cache.c_kv.shape[1]
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    c_kv = cache.c_kv.float()
    w_uk = params["w_uk"].float().reshape(r, H, cfg.qk_nope_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk)
    s = torch.einsum("bhr,bcr->bhc", q_abs, c_kv)
    s = s + torch.einsum("bhd,bcd->bhc", q_rope.float(),
                         cache.k_rope.float())
    valid = torch.arange(C, device=pos.device)[None] <= pos[:, None].long()
    s = torch.where(valid[:, None], s * scale, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhc,bcr->bhr", p, c_kv)
    w_uv = params["w_uv"].float().reshape(r, H, cfg.v_head_dim)
    return torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
