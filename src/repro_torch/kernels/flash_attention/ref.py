"""Plain PyTorch versions of the flash-attention kernels: the forward (the
port's copy of ``attention_ref``: full materialization), the forward with
each row's log-sum-exp (``attention_lse_ref``, what the forward kernel
saves for its backward) and the backward (``attention_bwd_ref``, explicit
formulas; the JAX package has no backward kernel, it differentiates its
jnp ``chunked_attention``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(Sq: int, Sk: int, causal: bool, window: int, device=None
            ) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i when j <= i (causal) and
    j > i - window (window > 0)."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k: (B, KV, Sk, hd); v: (B, KV, Sk, hd_v) with
    hd_v <= hd.  Full Sq x Sk softmax in float32 at scale hd**-0.5, masked
    scores at -1e30; returns (B, H, Sq, hd_v)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    groups = H // KV
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    mask = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """:func:`attention_ref` and each row's log-sum-exp of its scaled,
    masked scores, (B, H, Sq) float32 in natural log (masked scores at
    -1e30, so a row that sees no key gets -1e30).  The output is exp(s -
    lse) @ v, in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    groups = H // KV
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    mask = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    lse = torch.logsumexp(s, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                      window: int = 0, lse=None):
    """The gradients (dq, dk, dv) of :func:`attention_ref` at ``out`` for
    the output cotangent ``dout``, in float32 arithmetic, each in its
    input's dtype.  Layouts as in :func:`attention_ref`; out and dout are
    (B, H, Sq, hd_v).

    With s the scaled scores, P = softmax(s) over the visible keys
    (recomputed), D = rowsum(dout * out), dP = dout V^T and dS = P * (dP -
    D), zero at masked scores: dq = scale dS K, dk = scale dS^T Q and dv = P^T dout, dk and dv
    summed over each KV head's H / KV query heads.  Given ``lse`` (B, H,
    Sq), each row's log-sum-exp as :func:`attention_lse_ref` gives it, P
    is exp(s - lse) at the visible scores instead, as the backward kernels
    form it; the gradients are the same.  Computed one (batch row, KV
    head) at a time, so the float32 temporaries are G x Sq x Sk (G = H /
    KV) and not B x H x Sq x Sk."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    mask = visible(Sq, Sk, causal, window, q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        for g in range(KV):
            heads = slice(g * G, (g + 1) * G)
            qf, dof = q[b, heads].float(), dout[b, heads].float()
            kf, vf = k[b, g].float(), v[b, g].float()
            s = torch.where(mask, (qf @ kf.T) * scale, NEG_INF)
            if lse is None:
                p = torch.exp(s - s.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
            else:
                p = torch.where(mask, torch.exp(
                    s - lse[b, heads, :, None].float()), 0.0)
            d = (dof * out[b, heads].float()).sum(-1, keepdim=True)
            # a masked score is a constant: no gradient reaches it
            ds = torch.where(mask, p * (dof @ vf.T - d), 0.0)
            dq[b, heads] = scale * (ds @ kf)
            dk[b, g] = scale * torch.einsum("gqk,gqd->kd", ds, qf)
            dv[b, g] = torch.einsum("gqk,gqd->kd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
