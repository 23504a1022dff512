"""The causal LM (the port of ``repro.models.model``), as plain functions
over a parameter dictionary.

Parameters: ``{"embed": {"w"}, "head": {"w"}, "layers": [one dict per
layer], "final_norm": {"scale"}}``.  The JAX package stacks each period
position's layers for ``lax.scan``; here layer ``l`` is
``params["layers"][l]`` with descriptor ``cfg.layer_program()[l % period]``,
and the scan is a loop.  For serving, matrices are stored in ``cfg.dtype``,
norm scales and the Mamba parameters the JAX package uses in float32
(``mamba2.FLOAT32_PARAMS``) in float32 (the JAX package stores float32 and
casts at use, which gives the same values).  For training,
``init_params(param_dtype=torch.float32)`` stores every parameter in
float32, JAX's masters: the layers cast at use, so no forward value
changes, and an update of size lr * u stays above the masters' spacing.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import KVCache
from .blocks import layer_apply, layer_cache_init, layer_decode, layer_init
from .config import ModelConfig
from .layers import (cdtype, embed_apply, embed_init, head_apply, rms_norm,
                     rms_norm_init, rope_tables, softmax_cross_entropy)
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
                device=None, param_dtype: torch.dtype | None = None) -> dict:
    """Random parameters drawn layer by layer on ``device`` (each matrix in
    float32, then cast to the storage type), so the model never exists as
    one float32 copy beside its stored one.  ``generator`` is a
    ``torch.Generator`` on ``device`` or an integer seed.  The laws are the
    JAX ``init_params``'s; the bits are not (threefry is not reproduced).
    ``param_dtype``: the storage type of the matrices, ``cfg.dtype`` when
    None (serving); ``torch.float32`` keeps JAX's float32 masters
    (training).  Norm scales and ``mamba2.FLOAT32_PARAMS`` are float32
    either way.  On the ``meta`` device nothing is drawn
    (:func:`init_abstract`)."""
    device = resolve_device(device)
    descs = layer_descs(cfg)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(int(generator))
    dt = param_dtype or cdtype(cfg)
    params = embed_init(cfg, generator, device, dt)
    params["layers"] = [layer_init(cfg, d, generator, device, dt)
                        for d in descs]
    params["final_norm"] = rms_norm_init(cfg.d_model, device)
    return params


def init_abstract(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device, float32 as JAX stores it:
    shapes and dtypes without storage (JAX's ``eval_shape`` of
    ``init_params``, layer by layer where JAX stacks each period
    position's layers)."""
    return init_params(cfg, 0, "meta", param_dtype=torch.float32)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _inputs(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    if tokens is not None:
        return embed_apply(params, tokens, cfg)
    return embeds.to(cdtype(cfg))


def _remat(cfg: ModelConfig) -> bool:
    """Whether a layer's activations are recomputed in the backward pass:
    JAX wraps its scan body in ``jax.checkpoint`` when ``cfg.remat`` and
    the policy is not ``"full"``."""
    return cfg.remat and cfg.remat_policy != "full"


def hidden_states(params: dict, cfg: ModelConfig, *, tokens=None,
                  embeds=None, positions=None,
                  use_kernels: bool = True) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The residual stream after the last layer, before the final norm,
    and the MoE auxiliary loss summed over the layers (float32, 0 for a
    stack without MoE).

    With grad enabled and remat on (:func:`_remat`), each layer runs under
    ``torch.utils.checkpoint(use_reentrant=False)``: only its input is kept
    and its forward runs again in the backward pass, flash launch
    included.  That is JAX's ``jax.checkpoint(nothing_saveable)``;
    ``remat_policy="dots"`` (JAX: the matmul outputs without batch dims
    saveable) maps to the same here, saving nothing."""
    x = _inputs(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    rope = rope_by_mixer(cfg, positions)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg) and torch.is_grad_enabled()

    def layer(p, x, tables, desc):
        x, aux = layer_apply(p, x, tables, cfg, desc,
                             use_kernels=use_kernels)
        return x, aux.get("moe_aux_loss")

    for p, desc in zip(params["layers"], layer_descs(cfg)):
        tables = rope.get(desc[0])
        if remat:
            x, aux = checkpoint(layer, p, x, tables, desc,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = layer(p, x, tables, desc)
        if aux is not None:
            aux_loss = aux_loss + aux
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


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01, *, use_kernels: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """The training loss (JAX's ``loss_fn``): mean next-token cross-entropy
    over the batch's masked-in tokens plus ``aux_weight`` times the summed
    MoE load-balance loss.  ``batch`` holds ``tokens`` or ``embeds``,
    ``labels`` and optionally ``mask``.  Returns (total, {"ce_loss",
    "moe_aux_loss"})."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          use_kernels=use_kernels)
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + aux_weight * aux["moe_aux_loss"]
    return total, {"ce_loss": loss, **aux}


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


def init_cache_abstract(cfg: ModelConfig, batch: int, cache_len: int
                        ) -> list[Cache]:
    """:func:`init_cache` on the ``meta`` device: the caches' shapes and
    dtypes without storage (JAX's ``init_cache_abstract``, one cache per
    layer in the port's layouts)."""
    return init_cache(cfg, batch, cache_len, "meta")


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
