"""Mamba2 mixer — SSD (state-space duality), arXiv:2405.21060 (the port of
``repro.models.mamba2``).

Prefill runs the chunked SSD form: a quadratic form inside each chunk plus
the inter-chunk state recurrence.  ``mamba_apply`` hands the ``ssd_scan``
kernels (``kernels/ssd_scan``) views of the model's ``(B, nc, Lc, H, P)``
layout in their ``(B, H, nc, Lc, P)`` order (B and C per group, ``(B, G,
nc, Lc, N)``, in ``cfg.dtype``), which they read through the strides; they
run from a zero state and drop the final state, which is all the JAX
``mamba_apply`` needs.  ``use_kernels=False`` runs :func:`ssd_chunk_scan`,
the JAX package's jnp form, instead.  Decode is the O(1)-state recurrence,
plain PyTorch (the JAX package has no kernel for it), and updates the cache
in place.  Rounding points are the JAX package's: projections and the causal
conv in ``cfg.dtype``, the SSM in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd
from .config import ModelConfig
from .layers import cdtype, dense_init

#: Parameters the JAX package uses in float32 (the port stores them so);
#: every other Mamba parameter is cast to ``cfg.dtype`` where it is used.
FLOAT32_PARAMS = ("A_log", "D_skip", "dt_bias", "norm_scale")


def mamba_init(cfg: ModelConfig, generator, device, dtype) -> dict:
    """The JAX ``mamba_init`` laws; the bits differ from threefry's."""
    D, din = cfg.d_model, cfg.d_inner
    G, N, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * G * N
    zdim = 2 * din + 2 * G * N + nh          # [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=device)
    w_in = dense_init((D, zdim), generator, device).to(dtype)
    conv_w = torch.empty((cfg.ssm_conv, conv_dim), **f32)
    conv_w.normal_(0.0, 1.0, generator=generator).mul_(0.1)
    w_out = dense_init((din, D), generator, device).to(dtype)
    return {
        "w_in": w_in,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D_skip": torch.ones(nh, **f32),
        "dt_bias": torch.full((nh,), math.log(math.expm1(0.01)), **f32),
        "norm_scale": torch.ones(din, **f32),
        "w_out": w_out,
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, k-1, conv_dim) last inputs to the causal conv
    ssm: torch.Tensor     # (B, nh, hd, N) float32 state
    length: torch.Tensor  # () int32: decode steps taken


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> MambaCache:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                         dtype=cdtype(cfg), device=device),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def _split_proj(params, x: torch.Tensor, cfg: ModelConfig):
    din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    zxbcdt = x @ params["w_in"].to(cdtype(cfg))
    return torch.split(zxbcdt, [din, din + 2 * G * N, cfg.ssm_heads], dim=-1)


def _causal_conv(params, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU over the [x, B, C] channels; the k
    shifted products summed in the JAX package's order."""
    k, S = cfg.ssm_conv, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = params["conv_w"].to(xbc.dtype)                       # (k, conv_dim)
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(k))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _gated_norm(params, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    gf = (y * F.silu(z)).float()
    var = (gf * gf).mean(-1, keepdim=True)
    out = gf * torch.rsqrt(var + eps) * params["norm_scale"]
    return out.to(y.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (B, L, H) -> (B, H, L, L) lower-triangular pairwise sums
    exp-arg[i, j] = sum_{k=j+1..i} a_k for i >= j, -inf above."""
    cs = torch.cumsum(a, dim=1)                               # (B, L, H)
    d = cs[:, :, None, :] - cs[:, None, :, :]                 # (B, L, L, H)
    L = a.shape[1]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    d = torch.where(mask[None, :, :, None], d, -math.inf)
    return d.permute(0, 3, 1, 2)


def ssd_chunk_scan(xdt, Bm, Cm, a, state0):
    """The SSD core over pre-chunked inputs (the JAX package's jnp form).

    xdt: (B, nc, Lc, H, P) -- dt * x;  Bm, Cm: (B, nc, Lc, H, N);
    a: (B, nc, Lc, H) -- dt * A (negative);  state0: (B, H, P, N).
    Returns y (B, nc, Lc, H, P) and the final state.
    """
    S, ys = state0, []
    for c in range(xdt.shape[1]):
        x_c, B_c, C_c, a_c = xdt[:, c], Bm[:, c], Cm[:, c], a[:, c]
        cs = torch.cumsum(a_c, dim=1)                         # (B, Lc, H)
        Lmat = torch.exp(_segsum(a_c))                        # (B, H, Lc, Lc)
        cb = torch.einsum("blhn,bshn->bhls", C_c, B_c)
        y_diag = torch.einsum("bhls,bshp->blhp", cb * Lmat, x_c)
        y_off = torch.einsum("blhn,bhpn->blhp", C_c, S) * \
            torch.exp(cs)[..., None]
        decay_state = torch.exp(cs[:, -1:, :] - cs)           # (B, Lc, H)
        new_states = torch.einsum("blhn,blhp->bhpn",
                                  B_c * decay_state[..., None], x_c)
        S = S * torch.exp(cs[:, -1, :])[:, :, None, None] + new_states
        ys.append(y_diag + y_off)
    return torch.stack(ys, dim=1), S


def _heads(t: torch.Tensor, hpg: int, dim: int) -> torch.Tensor:
    """Broadcast groups to heads on ``dim``: head h reads group h // hpg
    (``jnp.repeat``, i.e. ``repeat_interleave``)."""
    return t.repeat_interleave(hpg, dim=dim) if hpg > 1 else t


def mamba_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence SSD (train / prefill). x: (B, S, D)."""
    dt_ = cdtype(cfg)
    B, S, _ = x.shape
    din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    nh, P = cfg.ssm_heads, cfg.ssm_head_dim
    Lc = min(cfg.ssm_chunk, S)
    assert S % Lc == 0, f"seq {S} % chunk {Lc}"
    nc = S // Lc

    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc = _causal_conv(params, xbc, cfg)
    xs, Bc, Cc = torch.split(xbc, [din, G * N, G * N], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])      # (B, S, nh)
    A = -torch.exp(params["A_log"])                          # (nh,)
    a = dt * A                                               # (B, S, nh)

    xh = xs.reshape(B, S, nh, P).float()
    xdt = xh * dt[..., None]
    hpg = nh // G
    if use_kernels:
        # views of the model's layout as the kernel's (B, H, nc, Lc, *) for
        # x and a and (B, G, nc, Lc, N) for B and C, which it reads by
        # group and in their own dtype: the kernel reads through the
        # strides, and writes y in (B, nc, Lc, H, P), so nothing is copied
        def groups(t):
            return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
        y = ssd(xdt.reshape(B, nc, Lc, nh, P).permute(0, 3, 1, 2, 4),
                groups(Bc), groups(Cc),
                a.reshape(B, nc, Lc, nh).permute(0, 3, 1, 2))
        y = y.permute(0, 2, 3, 1, 4)                         # (B, nc, Lc, H, P)
    else:
        def chunk(t):
            return t.reshape(B, nc, Lc, *t.shape[2:])
        Bm = _heads(Bc.reshape(B, S, G, N), hpg, 2).float()
        Cm = _heads(Cc.reshape(B, S, G, N), hpg, 2).float()
        state0 = torch.zeros((B, nh, P, N), dtype=torch.float32,
                             device=x.device)
        y, _ = ssd_chunk_scan(chunk(xdt), chunk(Bm), chunk(Cm), chunk(a),
                              state0)
    y = y.reshape(B, S, nh, P) + params["D_skip"][None, None, :, None] * xh
    y = _gated_norm(params, y.reshape(B, S, din).to(dt_), z, cfg.norm_eps)
    return y @ params["w_out"].to(dt_)


def mamba_decode(params, x: torch.Tensor, cache: MambaCache,
                 cfg: ModelConfig) -> tuple[torch.Tensor, MambaCache]:
    """One-token recurrence. x: (B, 1, D).  Writes the new conv window and
    state into the cache's tensors in place; positions do not enter (as in
    JAX)."""
    dt_ = cdtype(cfg)
    B = x.shape[0]
    din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    nh, P = cfg.ssm_heads, cfg.ssm_head_dim

    z, xbc, dt_raw = _split_proj(params, x, cfg)             # (B, 1, *)
    window = torch.cat([cache.conv, xbc.to(cache.conv.dtype)], dim=1)
    w = params["conv_w"].to(xbc.dtype)                       # (k, conv_dim)
    conv_out = (window * w[None]).sum(dim=1) + \
        params["conv_b"].to(xbc.dtype)
    xbc1 = F.silu(conv_out)                                  # (B, conv_dim)
    xs, Bc, Cc = torch.split(xbc1, [din, G * N, G * N], dim=-1)

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                # (B, nh)

    xh = xs.reshape(B, nh, P).float()
    hpg = nh // G
    Bm = _heads(Bc.reshape(B, G, N), hpg, 1).float()
    Cm = _heads(Cc.reshape(B, G, N), hpg, 1).float()

    S = cache.ssm * decay[:, :, None, None] + \
        (xh * dt[..., None])[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", S, Cm) + \
        params["D_skip"][None, :, None] * xh
    y = _gated_norm(params, y.reshape(B, 1, din).to(dt_), z, cfg.norm_eps)
    cache.conv.copy_(window[:, 1:])
    cache.ssm.copy_(S)
    cache = MambaCache(cache.conv, cache.ssm, cache.length + 1)
    return y @ params["w_out"].to(dt_), cache
