"""Decoder blocks (the port of ``repro.models.blocks``): pre-norm mixer +
residual, then pre-norm FFN + residual.

The port runs the ``attn`` and ``mamba`` mixers with a dense or no FFN.
The MLA and MoE kinds raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import torch

from .attention import attn_apply, attn_decode, attn_init, init_kv_cache
from .config import ModelConfig
from .layers import mlp_apply, mlp_init, rms_norm, rms_norm_init
from .mamba2 import init_mamba_cache, mamba_apply, mamba_decode, mamba_init

#: Layer kinds the port does not run yet -> the ROADMAP item.
TODO = {
    "mla": "ROADMAP queue 1 item 11d (MLA)",
    "moe": "ROADMAP queue 1 item 11e (MoE)",
}


def check_desc(cfg: ModelConfig, desc) -> None:
    for kind in desc:
        if kind in TODO:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers are not ported yet: "
                f"{TODO[kind]}")


def layer_init(cfg: ModelConfig, desc, generator, device, dtype) -> dict:
    check_desc(cfg, desc)
    mixer_kind, ffn_kind = desc
    init = attn_init if mixer_kind == "attn" else mamba_init
    p = {"mixer_norm": rms_norm_init(cfg.d_model, device),
         "mixer": init(cfg, generator, device, dtype)}
    if ffn_kind == "dense":
        p["ffn_norm"] = rms_norm_init(cfg.d_model, device)
        p["ffn"] = mlp_init(cfg.d_model, cfg.d_ff, generator, device, dtype)
    return p


def _ffn(params, x: torch.Tensor, cfg: ModelConfig, ffn_kind) -> torch.Tensor:
    if ffn_kind == "none":
        return x
    h = rms_norm(params["ffn_norm"], x, cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg)


def layer_apply(params, x, rope, cfg: ModelConfig, desc, *,
                use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence (train / prefill) layer; rope: the positions' RoPE
    tables (a Mamba layer reads none)."""
    check_desc(cfg, desc)
    h = rms_norm(params["mixer_norm"], x, cfg.norm_eps)
    if desc[0] == "attn":
        h = attn_apply(params["mixer"], h, rope, cfg, use_kernels=use_kernels)
    else:
        h = mamba_apply(params["mixer"], h, cfg, use_kernels=use_kernels)
    return _ffn(params, x + h, cfg, desc[1])


def layer_cache_init(cfg: ModelConfig, desc, batch: int, cache_len: int,
                     device):
    check_desc(cfg, desc)
    if desc[0] == "attn":
        return init_kv_cache(cfg, batch, cache_len, device)
    return init_mamba_cache(cfg, batch, device)


def layer_decode(params, x, pos, rope, cache, cfg: ModelConfig, desc, *,
                 use_kernels: bool = True):
    """One-token decode step.  x: (B, 1, D); pos: (B,) int32; rope: its
    RoPE tables (a Mamba layer reads neither)."""
    check_desc(cfg, desc)
    h = rms_norm(params["mixer_norm"], x, cfg.norm_eps)
    if desc[0] == "attn":
        h, cache = attn_decode(params["mixer"], h, pos, rope, cache, cfg,
                               use_kernels=use_kernels)
    else:
        h, cache = mamba_decode(params["mixer"], h, cache, cfg)
    return _ffn(params, x + h, cfg, desc[1]), cache
