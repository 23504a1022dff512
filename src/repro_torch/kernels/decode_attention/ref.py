"""Plain PyTorch version of the decode-attention kernel (the port's copy
of ``decode_attention_ref``, with one position per row)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` as a (batch,) int32 tensor: an int or a 0-d tensor (the TPU
    kernel's scalar, the same for every row) is broadcast; a (batch,)
    tensor is one position per row."""
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos.ndim == 0:
        return pos.expand(batch).contiguous()
    if pos.shape != (batch,):
        raise ValueError(f"pos must be a scalar or ({batch},), got "
                         f"{tuple(pos.shape)}")
    return pos


def decode_attention_ref(q, k, v, pos, *, window: int = 0):
    """q: (B, H, hd); k, v: (B, KV, C, hd); pos: (B,) (or scalar) index of
    each row's last valid cache slot.  Softmax over the whole cache in
    float32, invalid slots at -1e30."""
    B, H, hd = q.shape
    KV, C = k.shape[1], k.shape[2]
    G = H // KV
    pos = row_positions(pos, B, q.device).long()
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bkcd->bkgc", qg, k.float()) * hd**-0.5
    c_pos = torch.arange(C, device=q.device)
    valid = c_pos[None, :] <= pos[:, None]                       # (B, C)
    if window:
        valid &= c_pos[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgc,bkcd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def share_bounds(pos, C: int, window: int, shares: int) -> torch.Tensor:
    """(shares, B, 2) first and last cache row of each share of each batch
    row, as the kernel's cluster cuts them: the valid rows [lo, hi] (the
    whole cache when none is valid) in ``shares`` contiguous runs, share r
    starting at lo + n r // shares; a share may be empty (last < first)."""
    pos = pos.long()
    lo = (pos - window + 1).clamp_min(0) if window else torch.zeros_like(pos)
    hi = pos.clamp_max(C - 1)
    none = lo > hi
    lo, hi = torch.where(none, 0, lo), torch.where(none, C - 1, hi)
    n = hi - lo + 1
    r = torch.arange(shares, device=pos.device)[:, None]
    return torch.stack([lo + n * r // shares, lo + n * (r + 1) // shares - 1],
                       dim=-1)


def share_partials(q, k, v, pos, *, window: int = 0, shares: int):
    """Each share's online-softmax state, as one block of the kernel's
    cluster keeps it: m (shares, B, KV, G), the largest masked score of the
    share's rows (-1e30 when it has none); l (shares, B, KV, G), the sum of
    exp(score - m) over them; acc (shares, B, KV, G, hd), those weights
    times v.  Scores are masked at -1e30 as in
    :func:`decode_attention_ref`."""
    B, H, hd = q.shape
    KV, C = k.shape[1], k.shape[2]
    pos = row_positions(pos, B, q.device).long()
    s = torch.einsum("bkgd,bkcd->bkgc", q.reshape(B, KV, H // KV, hd).float(),
                     k.float()) * hd**-0.5
    c_pos = torch.arange(C, device=q.device)
    valid = c_pos[None, :] <= pos[:, None]
    if window:
        valid &= c_pos[None, :] > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    bounds = share_bounds(pos, C, window, shares)           # (S, B, 2)
    inside = (c_pos >= bounds[..., :1]) & (c_pos <= bounds[..., 1:])
    inside = inside[:, :, None, None, :]                    # (S, B, 1, 1, C)
    m = torch.where(inside, s, NEG_INF).amax(-1)
    p = torch.where(inside, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("sbkgc,bkcd->sbkgd", p, v.float())


def merge_partials(m, l, acc):
    """The kernel's combine of per-share (m, l, acc) (leading share axis):
    m* = max m_i, weights exp(m_i - m*) on l_i and acc_i, out = acc /
    max(l, 1e-30).  Returns (B, KV, G, hd) float32."""
    w = torch.exp(m - m.amax(0))
    return (w[..., None] * acc).sum(0) / \
        (w * l).sum(0).clamp_min(1e-30)[..., None]
