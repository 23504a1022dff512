"""The causal LM (the port of ``repro.models.model``), as plain functions
over a parameter dictionary.

Parameters: ``{"embed": {"w"}, "head": {"w"}, "layers": [one dict per
layer], "final_norm": {"scale"}}``.  The JAX package stacks each period
position's layers for ``lax.scan``; here layer ``l`` is
``params["layers"][l]`` with descriptor ``cfg.layer_program()[l % period]``,
and the scan is a loop.  Matrices are stored in ``cfg.dtype``, norm scales
and the Mamba parameters the JAX package uses in float32
(``mamba2.FLOAT32_PARAMS``) in float32 (the JAX package stores float32 and
casts at use, which gives the same values).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .attention import KVCache
from .blocks import layer_apply, layer_cache_init, layer_decode, layer_init
from .config import ModelConfig
from .layers import (cdtype, embed_apply, embed_init, head_apply, rms_norm,
                     rms_norm_init, rope_tables)
from .mamba2 import MambaCache
from .mla import MLACache

Cache = KVCache | MLACache | MambaCache


def layer_descs(cfg: ModelConfig) -> list:
    """The descriptor of every layer, in order."""
    program = cfg.layer_program()
    return [program[i % len(program)] for i in range(cfg.num_layers)]


def rope_by_mixer(cfg: ModelConfig, positions: torch.Tensor) -> dict:
    """The RoPE tables of ``positions`` for each mixer kind of the stack
    that rotates: GQA attention at ``resolved_head_dim``, MLA at
    ``qk_rope_dim`` (JAX takes the width from the rotated tensor).  Every
    layer of a kind rotates at the same positions, so one set each."""
    widths = {"attn": cfg.resolved_head_dim, "mla": cfg.qk_rope_dim}
    return {kind: rope_tables(positions, widths[kind], cfg.rope_theta)
            for kind in {d[0] for d in layer_descs(cfg)} if kind in widths}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: int | torch.Generator = 0,
                device=None) -> dict:
    """Random parameters drawn layer by layer on ``device`` (each matrix in
    float32, then cast to ``cfg.dtype``), so the model never exists as one
    float32 copy.  ``generator`` is a ``torch.Generator`` on ``device`` or
    an integer seed.  The laws are the JAX ``init_params``'s; the bits are
    not (threefry is not reproduced)."""
    device = resolve_device(device)
    descs = layer_descs(cfg)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=device).manual_seed(int(generator))
    dt = cdtype(cfg)
    params = embed_init(cfg, generator, device, dt)
    params["layers"] = [layer_init(cfg, d, generator, device, dt)
                        for d in descs]
    params["final_norm"] = rms_norm_init(cfg.d_model, device)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _inputs(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    if tokens is not None:
        return embed_apply(params, tokens, cfg)
    return embeds.to(cdtype(cfg))


def hidden_states(params: dict, cfg: ModelConfig, *, tokens=None,
                  embeds=None, positions=None,
                  use_kernels: bool = True) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The residual stream after the last layer, before the final norm,
    and the MoE auxiliary loss summed over the layers (float32, 0 for a
    stack without MoE)."""
    x = _inputs(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    rope = rope_by_mixer(cfg, positions)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, desc in zip(params["layers"], layer_descs(cfg)):
        x, aux = layer_apply(p, x, rope.get(desc[0]), cfg, desc,
                             use_kernels=use_kernels)
        if "moe_aux_loss" in aux:
            aux_loss = aux_loss + aux["moe_aux_loss"]
    return x, aux_loss


def forward(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, use_kernels: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """Returns (logits (B, S, V), aux metrics: ``moe_aux_loss`` summed over
    the layers).  ``use_kernels=False`` runs the attention kernels' plain
    versions and the plain chunked SSD scan (``mamba2.ssd_chunk_scan``) on
    any device."""
    x, aux_loss = hidden_states(params, cfg, tokens=tokens, embeds=embeds,
                                positions=positions, use_kernels=use_kernels)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return head_apply(params, x, cfg), {"moe_aux_loss": aux_loss}


def prefill(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            use_kernels: bool = True) -> torch.Tensor:
    """Last-position logits (B, V) of the forward pass.  The norm and head
    are row-wise, so they run on the last position only."""
    x = hidden_states(params, cfg, tokens=tokens, embeds=embeds,
                      use_kernels=use_kernels)[0][:, -1]
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return head_apply(params, x, cfg)


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> list[Cache]:
    """One cache per layer, in layer order: a ``KVCache`` for an attention
    layer (a ring of ``min(cache_len, window)`` slots with a sliding
    window), an ``MLACache`` for an MLA layer, a ``MambaCache`` (conv
    window and SSM state; ``cache_len`` does not enter) for a Mamba
    layer."""
    device = resolve_device(device)
    return [layer_cache_init(cfg, d, batch, cache_len, device)
            for d in layer_descs(cfg)]


def decode_step(params: dict, cfg: ModelConfig, tokens_or_embeds, pos,
                caches: list[Cache], *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, list[Cache]]:
    """One decode step for the whole batch.

    tokens_or_embeds: (B, 1) int tokens or (B, 1, D) embeds; pos: (B,) int32
    absolute position of each row (a scalar means the same for every row).
    The caches are updated in place.  Each row is routed through an MoE
    FFN on its own, as in the JAX serving engine's ``vmap`` over requests
    (JAX's ``decode_step`` called with B > 1 would route the batch
    together).  Returns (logits (B, 1, V), caches).
    """
    if tokens_or_embeds.ndim == 2:
        x = embed_apply(params, tokens_or_embeds, cfg)
    else:
        x = tokens_or_embeds.to(cdtype(cfg))
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    pos = pos.expand(B).contiguous() if pos.ndim == 0 else pos
    rope = rope_by_mixer(cfg, pos.reshape(B, 1))
    new_caches = []
    for p, desc, cache in zip(params["layers"], layer_descs(cfg), caches):
        x, cache = layer_decode(p, x, pos, rope.get(desc[0]), cache, cfg,
                                desc, use_kernels=use_kernels)
        new_caches.append(cache)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return head_apply(params, x, cfg), new_caches
