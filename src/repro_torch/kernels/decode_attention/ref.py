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
