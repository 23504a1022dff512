"""Decoder blocks (the port of ``repro.models.blocks``): pre-norm mixer +
residual, then pre-norm FFN + residual, with the mixer (GQA attention,
MLA or Mamba2) and the FFN (dense SwiGLU, MoE or none) chosen by the layer
descriptor.
"""
from __future__ import annotations

import torch

from .attention import attn_apply, attn_decode, attn_init, init_kv_cache
from .config import ModelConfig
from .layers import mlp_apply, mlp_init, rms_norm, rms_norm_init
from .mamba2 import init_mamba_cache, mamba_apply, mamba_decode, mamba_init
from .mla import init_mla_cache, mla_apply, mla_decode, mla_init
from .moe import moe_apply, moe_init

_INIT = {"attn": attn_init, "mla": mla_init, "mamba": mamba_init}


def layer_init(cfg: ModelConfig, desc, generator, device, dtype) -> dict:
    mixer_kind, ffn_kind = desc
    p = {"mixer_norm": rms_norm_init(cfg.d_model, device),
         "mixer": _INIT[mixer_kind](cfg, generator, device, dtype)}
    if ffn_kind != "none":
        p["ffn_norm"] = rms_norm_init(cfg.d_model, device)
        p["ffn"] = mlp_init(cfg.d_model, cfg.d_ff, generator, device, dtype) \
            if ffn_kind == "dense" else moe_init(cfg, generator, device, dtype)
    return p


def _ffn(params, x: torch.Tensor, cfg: ModelConfig, ffn_kind, *,
         per_row: bool = False) -> tuple[torch.Tensor, dict]:
    if ffn_kind == "none":
        return x, {}
    h = rms_norm(params["ffn_norm"], x, cfg.norm_eps)
    if ffn_kind == "dense":
        return x + mlp_apply(params["ffn"], h, cfg), {}
    h, aux = moe_apply(params["ffn"], h, cfg, per_row=per_row)
    return x + h, aux


def layer_apply(params, x, rope, cfg: ModelConfig, desc, *,
                use_kernels: bool = True) -> tuple[torch.Tensor, dict]:
    """Full-sequence (train / prefill) layer -> (x, aux metrics: the MoE
    ones, or none); rope: the RoPE tables of the positions at the mixer's
    width (a Mamba layer reads none)."""
    mixer_kind, ffn_kind = desc
    h = rms_norm(params["mixer_norm"], x, cfg.norm_eps)
    if mixer_kind == "attn":
        h = attn_apply(params["mixer"], h, rope, cfg, use_kernels=use_kernels)
    elif mixer_kind == "mla":
        h = mla_apply(params["mixer"], h, rope, cfg, use_kernels=use_kernels)
    else:
        h = mamba_apply(params["mixer"], h, cfg, use_kernels=use_kernels)
    return _ffn(params, x + h, cfg, ffn_kind)


def layer_cache_init(cfg: ModelConfig, desc, batch: int, cache_len: int,
                     device):
    if desc[0] == "attn":
        return init_kv_cache(cfg, batch, cache_len, device)
    if desc[0] == "mla":
        return init_mla_cache(cfg, batch, cache_len, device)
    return init_mamba_cache(cfg, batch, device)


def layer_decode(params, x, pos, rope, cache, cfg: ModelConfig, desc, *,
                 use_kernels: bool = True):
    """One-token decode step.  x: (B, 1, D); pos: (B,) int32; rope: its
    RoPE tables at the mixer's width (a Mamba layer reads neither).  Each
    row is routed through an MoE FFN on its own, as under the JAX
    engine's vmap."""
    mixer_kind, ffn_kind = desc
    h = rms_norm(params["mixer_norm"], x, cfg.norm_eps)
    if mixer_kind == "attn":
        h, cache = attn_decode(params["mixer"], h, pos, rope, cache, cfg,
                               use_kernels=use_kernels)
    elif mixer_kind == "mla":
        h, cache = mla_decode(params["mixer"], h, pos, rope, cache, cfg,
                              use_kernels=use_kernels)
    else:
        h, cache = mamba_decode(params["mixer"], h, cache, cfg)
    x, _ = _ffn(params, x + h, cfg, ffn_kind, per_row=True)
    return x, cache
