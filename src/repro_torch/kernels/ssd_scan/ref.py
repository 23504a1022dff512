"""Plain PyTorch versions of the SSD chunk scan.

``ssd_ref`` is the port's copy of the JAX ``ssd_ref``: the naive
sequential state-space recurrence, no chunking,

h_t = exp(a_t) * h_{t-1} + (dt*x)_t B_t^T ;  y_t = h_t C_t

and the plain version of the whole call.  ``chunk_states_ref``,
``state_pass_ref`` and ``chunk_scan_ref`` are the plain versions of the
kernel's three stages (``csrc/ssd_scan.cu``), with its decays formed from
per-tile sums; ``ssd_stages_ref`` composes them.  ``split_tf32`` cuts a
float32 tensor into the two TF32 parts the kernel multiplies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Rows per tile of the kernel, over which the decays' partial sums run.
TILE = 64

#: float32 bits kept by TF32: sign, exponent and the top 10 mantissa bits.
_TF32_MASK = -8192                      # 0xffffe000 as an int32


def ssd_ref(xdt, Bm, Cm, a):
    """xdt: (B, H, nc, Lc, hd); Bm, Cm: (B, G, nc, Lc, N), head h reading
    group h // (H // G); a: (B, H, nc, Lc).  The recurrence in float32 from
    a zero state; y in xdt's dtype."""
    B, H, nc, Lc, hd = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    Bm, Cm = _heads(Bm, H // G), _heads(Cm, H // G)
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


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with v = hi + lo + r, |r| < 2^-20 |v|: hi is float32 ``v``
    with the low 13 mantissa bits cleared (a TF32 value), lo the rest
    cleared the same way.  hi.hi + hi.lo + lo.hi is the kernel's product."""
    v = v.float()
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def _heads(t: torch.Tensor, hpg: int) -> torch.Tensor:
    """(B, G, ...) per group -> (B, H, ...) per head: head h reads group
    h // hpg."""
    return t.repeat_interleave(hpg, dim=1) if hpg > 1 else t


def _tile_sums(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a (..., Lc) -> loc (..., nt * TILE), the cumsum of a inside each
    TILE-row tile (zero past Lc), and tot (..., nt), the tiles' sums."""
    Lc = a.shape[-1]
    nt = -(-Lc // TILE)
    ap = F.pad(a.float(), (0, nt * TILE - Lc))
    loc = ap.reshape(*a.shape[:-1], nt, TILE).cumsum(-1)
    return loc.reshape(*a.shape[:-1], nt * TILE), loc[..., -1]


def _spans(tot: torch.Tensor) -> torch.Tensor:
    """tot (..., nt) -> span (..., nt, nt), span[u, v] = sum of tot over
    tiles v..u-1 (0 where v >= u): a sum over the tiles between, never a
    difference of long cumsums."""
    nt = tot.shape[-1]
    k = torch.arange(nt, device=tot.device)
    between = (k[None, :, None] <= k[None, None, :]) & \
        (k[None, None, :] < k[:, None, None])         # [u, v, t]: v <= t < u
    return (tot[..., None, None, :] * between).sum(-1)


def chunk_states_ref(xdt, Bm, a):
    """Stage 1: states (B, H, nc, hd, N), s_c = x^T (B o exp(cs_last - cs))
    per chunk, and totals (B, H, nc), cs_last, both float32."""
    H, Lc = xdt.shape[1], xdt.shape[3]
    x = xdt.float()
    Bh = _heads(Bm.float(), H // Bm.shape[1])
    loc, tot = _tile_sums(a)
    rest = tot.flip(-1).cumsum(-1).flip(-1)           # a over tiles t..nt-1
    w = torch.exp(rest.repeat_interleave(TILE, -1) - loc)[..., :Lc]
    states = torch.einsum("bhclp,bhcln->bhcpn", x, Bh * w[..., None])
    return states, tot.sum(-1)


def state_pass_ref(states, totals):
    """Stage 2: the state each chunk starts from, (B, H, nc, hd, N):
    S_{-1} = 0, S_c = S_{c-1} exp(totals_c) + states_c."""
    S = torch.zeros_like(states[:, :, 0])
    starts = []
    for c in range(states.shape[2]):
        starts.append(S)
        S = S * torch.exp(totals[:, :, c])[..., None, None] + states[:, :, c]
    return torch.stack(starts, dim=2)


def chunk_scan_ref(xdt, Bm, Cm, a, starts):
    """Stage 3: y (B, H, nc, Lc, hd) float32 = ((C B^T) o L) x + (C S^T) o
    exp(cs), S = ``starts``; cs_i - cs_j = loc_i - loc_j + the totals of
    the tiles between."""
    H, Lc = xdt.shape[1], xdt.shape[3]
    x = xdt.float()
    Bh = _heads(Bm.float(), H // Bm.shape[1])
    Ch = _heads(Cm.float(), H // Cm.shape[1])
    loc, tot = _tile_sums(a)
    loc = loc[..., :Lc]
    span = _spans(tot)                                 # (B, H, nc, nt, nt)
    tile = torch.arange(Lc, device=xdt.device) // TILE
    between = span[..., tile[:, None], tile[None, :]]  # (B, H, nc, Lc, Lc)
    seg = loc[..., :, None] - loc[..., None, :] + between
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=xdt.device).tril()
    Lmat = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    scores = torch.einsum("bhcin,bhcjn->bhcij", Ch, Bh)
    y = torch.einsum("bhcij,bhcjp->bhcip", scores * Lmat, x)
    cs = span[..., tile, 0] + loc                      # (B, H, nc, Lc)
    y_off = torch.einsum("bhcin,bhcpn->bhcip", Ch, starts.float())
    return y + y_off * torch.exp(cs)[..., None]


def ssd_stages_ref(xdt, Bm, Cm, a):
    """The three stages composed: the chunk scan from a zero state, y in
    xdt's dtype (the same function as :func:`ssd_ref`)."""
    states, totals = chunk_states_ref(xdt, Bm, a)
    y = chunk_scan_ref(xdt, Bm, Cm, a, state_pass_ref(states, totals))
    return y.to(xdt.dtype)
