"""Plain PyTorch version of the SSD chunk-scan kernel (the port's copy of
``ssd_ref``): the naive sequential state-space recurrence, no chunking.

h_t = exp(a_t) * h_{t-1} + (dt*x)_t B_t^T ;  y_t = h_t C_t
"""
from __future__ import annotations

import torch


def ssd_ref(xdt, Bm, Cm, a):
    """xdt: (B, H, nc, Lc, hd); Bm, Cm: (B, G, nc, Lc, N), head h reading
    group h // (H // G); a: (B, H, nc, Lc).  The recurrence in float32 from
    a zero state; y in xdt's dtype."""
    B, H, nc, Lc, hd = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    if G != H:
        Bm, Cm = (t.repeat_interleave(H // G, dim=1) for t in (Bm, Cm))
    S = nc * Lc
    x = xdt.reshape(B, H, S, hd).float()
    Bf = Bm.reshape(B, H, S, N).float()
    Cf = Cm.reshape(B, H, S, N).float()
    af = a.reshape(B, H, S).float()
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(af[:, :, t])[..., None, None] + \
            x[:, :, t, :, None] * Bf[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, :, t]))
    y = torch.stack(ys, dim=2) if ys else x.new_zeros((B, H, 0, hd))
    return y.reshape(B, H, nc, Lc, hd).to(xdt.dtype)
