"""Plain PyTorch version of the flash-attention kernel (the port's copy of
``attention_ref``: full materialization)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd).  Full Sq x Sk softmax in
    float32, masked scores at -1e30."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    groups = H // KV
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
