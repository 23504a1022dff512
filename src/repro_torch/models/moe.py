"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch (the
port of ``repro.models.moe``).

Tokens are sorted by expert, ranked inside each expert's run, and kept up
to the capacity ``int(capacity_factor * T * k / E) + 1``; a dropped token
is sent nowhere.  The experts run as batched products over the expert
axis on ``(E, capacity, D)`` (the JAX package's einsums; no kernel), the
shared experts as one SwiGLU MLP.

Capacity is taken over the tokens routed together.  ``forward`` routes all
``B * S`` tokens together, as JAX's does.  The JAX serving engine decodes
under ``jax.vmap`` over requests, so there each row is routed on its own
with ``T = 1`` and, with ``k <= E``, never drops a token; the port's decode
batches the rows in one call, so it passes ``per_row=True``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import cdtype, dense_init, mlp_apply, mlp_init


def moe_init(cfg: ModelConfig, generator, device, dtype) -> dict:
    """The JAX ``moe_init`` laws (the expert stacks' fan-in is their first
    axis, E, as there); the bits differ from threefry's."""
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": dense_init((D, E), generator, device, 0.1).to(dtype)}
    for name, shape in (("w_gate", (E, D, Fd)), ("w_in", (E, D, Fd)),
                        ("w_out", (E, Fd, D))):
        p[name] = dense_init(shape, generator, device).to(dtype)
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(D, Fd * cfg.num_shared_experts, generator,
                               device, dtype)
    return p


def route(params, xf: torch.Tensor, cfg: ModelConfig):
    """The router on tokens xf (..., T, D): softmax probabilities (..., T,
    E) in float32, and the top-k weights, renormalised, and experts (...,
    T, k)."""
    logits = (xf @ params["router"].to(cdtype(cfg))).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
              per_row: bool = False) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D), aux metrics (Switch load-balance loss,
    drop rate).  ``per_row`` routes each of the B rows on its own (T = S,
    the JAX engine's vmapped decode; the metrics are then the means over
    the rows); else the B * S tokens are routed together."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G, T = (B, S) if per_row else (1, B * S)
    capacity = int(cfg.capacity_factor * T * k / E) + 1
    dev = x.device

    xf = x.reshape(G, T, D)
    probs, top_w, top_e = route(params, xf, cfg)    # (G, T, E), (G, T, k)

    # -- load-balance auxiliary (Switch-style) -----------------------------
    me = probs.mean(dim=1)                                       # (G, E)
    ce = torch.zeros(G, E, device=dev).scatter_add_(
        1, top_e.reshape(G, -1), torch.ones(G, T * k, device=dev)) / (T * k)
    aux_loss = E * (me * ce).sum(-1)

    # -- capacity dispatch via a stable sort by expert ----------------------
    e_flat = top_e.reshape(G, T * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = e_flat.gather(1, order)
    tok_sorted = order // k                  # token of each routed pair
    w_sorted = top_w.reshape(G, T * k).gather(1, order)
    group_start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(G, E).contiguous(),
        side="left")
    rank = torch.arange(T * k, device=dev) - group_start.gather(1, e_sorted)
    keep = rank < capacity
    slot = e_sorted * capacity + rank.clamp_max(capacity - 1)

    # the row past E * capacity takes the dropped pairs and is cut off
    rows = torch.arange(G, device=dev)[:, None]
    x_disp = torch.zeros(G, E * capacity + 1, D, dtype=dt, device=dev)
    x_disp[rows, torch.where(keep, slot, E * capacity)] = xf[rows, tok_sorted]
    x_disp = x_disp[:, :-1].reshape(G, E, capacity, D).transpose(0, 1)
    x_disp = x_disp.reshape(E, G * capacity, D)

    # -- experts: batched products over the expert axis ----------------------
    g = torch.bmm(x_disp, params["w_gate"].to(dt))
    h = torch.bmm(x_disp, params["w_in"].to(dt))
    y_e = torch.bmm(F.silu(g) * h, params["w_out"].to(dt))     # (E, G*c, D)
    y_e = y_e.reshape(E, G, capacity, D).transpose(0, 1).reshape(
        G, E * capacity, D)

    # -- combine -----------------------------------------------------------
    contrib = y_e[rows, slot] * (w_sorted * keep)[..., None].to(dt)
    y = torch.zeros(G, T, D, dtype=dt, device=dev).index_put_(
        (rows.expand(G, T * k), tok_sorted), contrib, accumulate=True)
    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], xf, cfg)

    drop_rate = 1.0 - keep.float().mean()
    return y.reshape(B, S, D), {"moe_aux_loss": aux_loss.mean(),
                                "moe_drop_rate": drop_rate}
