"""Shared layers: RMSNorm, SwiGLU MLP, embeddings, RoPE (the port of
``repro.models.layers``).  Plain functions over parameter dictionaries.

The rounding points are the JAX package's: a parameter is cast to
``cfg.dtype`` where it is used (for serving the port stores matrices in
``cfg.dtype`` already, so the cast is free and the values are the same;
training keeps float32 masters, as JAX does), ``rms_norm``
and RoPE compute in float32 and cast back, and logits are float32 when
``cfg.logits_fp32``.  Large products are ``torch.matmul``, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(shape, generator: torch.Generator, device,
               scale: float = 1.0) -> torch.Tensor:
    """float32 truncated normal on [-3, 3] times scale over sqrt(fan_in =
    shape[0]) (the JAX ``dense_init`` law; the bits differ from
    threefry's)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(scale / math.sqrt(shape[0]))


# -- RMSNorm -----------------------------------------------------------------
def rms_norm_init(d: int, device) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# -- SwiGLU MLP ---------------------------------------------------------------
def mlp_init(d_model: int, d_ff: int, generator, device, dtype) -> dict:
    return {name: dense_init(shape, generator, device).to(dtype)
            for name, shape in (("w_gate", (d_model, d_ff)),
                                ("w_in", (d_model, d_ff)),
                                ("w_out", (d_ff, d_model)))}


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    g = x @ params["w_gate"].to(dt)
    h = x @ params["w_in"].to(dt)
    return (F.silu(g) * h) @ params["w_out"].to(dt)


# -- Embedding / LM head --------------------------------------------------------
def embed_init(cfg: ModelConfig, generator, device, dtype) -> dict:
    w = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                    device=device)
    w.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    p = {"embed": {"w": w.to(dtype)}}
    del w
    if not cfg.tie_embeddings:
        p["head"] = {"w": dense_init((cfg.d_model, cfg.vocab_size), generator,
                                     device).to(dtype)}
    return p


def embed_apply(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"]["w"].to(cdtype(cfg))[tokens]


def head_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"]["w"].T if cfg.tie_embeddings else params["head"]["w"]
    logits = x @ w.to(x.dtype)
    return logits.float() if cfg.logits_fp32 else logits


# -- losses ---------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V), labels (B, S) int.  With
    a mask, the mean over the masked-in tokens, the count floored at 1."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# -- RoPE ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of RoPE's angles, float32 (..., S, 1, hd/2), for
    positions (..., S)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None, None].float() * freqs   # (..., S, 1, hd/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE of x (..., S, H, hd) by tables from :func:`rope_tables`."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S), e.g.
    ``(B, 1)`` for one token per row at its own position."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
