"""Plain PyTorch versions of the SSD chunk scan.

``ssd_ref`` is the port's copy of the JAX ``ssd_ref``: the naive
sequential state-space recurrence, no chunking,

h_t = exp(a_t) * h_{t-1} + (dt*x)_t B_t^T ;  y_t = h_t C_t

and the plain version of the whole call.  ``chunk_states_ref``,
``state_pass_ref`` and ``chunk_scan_ref`` are the plain versions of the
kernel's three stages (``csrc/ssd_scan.cu``), with its decays formed from
per-tile sums; ``ssd_stages_ref`` composes them.  ``split_tf32`` cuts a
float32 tensor into the two TF32 parts the kernel multiplies.

The backward (``csrc/ssd_scan_bwd.cu``) has its plain stages too:
``chunk_dstates_ref``, ``state_pass_bwd_ref``, ``chunk_scan_bwd_ref`` and
``group_sum_ref``, composed by ``ssd_bwd_ref``, with dcs from the rows
and columns of M as written below; and the stages as the kernels cut the
work, ``state_pass_bwd_sliced_ref`` (the end-state product in per-slice
shares), ``chunk_scan_bwd_rows_ref`` (dcs in its closed form, dy_i.y_i -
x_i.dx_i, from ``dcs_ref``) and ``da_ref`` (the reverse cumsum with the
end-state product on each chunk's last row), composed by
``ssd_bwd_stages_ref``.  For one (b, h) and chunk c, with S_c the state
the chunk starts from and Q_c the gradient reaching the state it ends
in:

    dS_c  = sum_i exp(cs_i) dy_i C_i^T
    R_c   = dS_c + exp(T_c) R_{c+1}, R_nc = 0;  Q_c = R_{c+1}
    dT_c  = exp(T_c) <R_{c+1}, S_c>
    dx_j  = sum_{i>=j} (C_i.B_j) L_ij dy_i + exp(T_c - cs_j) Q_c B_j
    dB_j  = sum_{i>=j} (dy_i.x_j) L_ij C_i + exp(T_c - cs_j) Q_c^T x_j
    dC_i  = sum_{j<=i} (dy_i.x_j) L_ij B_j + exp(cs_i) S_c^T dy_i
    dcs_i = sum_j M_ij - sum_k M_ki + dy_i.y_off_i - W_i,
            M_ij = (C_i.B_j)(dy_i.x_j) L_ij, W_j = exp(T_c - cs_j) x_j.Q_c B_j,
            and dcs_last += sum_j W_j + dT_c
    da_k  = sum_{i>=k} dcs_i

with T_c = cs_last and L_ij = exp(cs_i - cs_j) for i >= j.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: Rows per tile of the kernel, over which the decays' partial sums run.
TILE = 64

#: State entries (of hd * N) a block of the backward's reverse pass takes.
PASS_SLICE = 1024

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


def _decays(a, Lc):
    """Per-tile decay pieces of a chunk: ``seg`` (..., Lc, Lc) = cs_i -
    cs_j (meaningful for i >= j), ``cs`` (..., Lc) and ``rest`` (..., Lc)
    = T - cs_j, each from the tile sums (``_tile_sums``), never as the
    difference of two long cumsums."""
    loc, tot = _tile_sums(a)
    span = _spans(tot)                                 # (..., nt, nt)
    tile = torch.arange(Lc, device=a.device) // TILE
    loc = loc[..., :Lc]
    between = span[..., tile[:, None], tile[None, :]]
    seg = loc[..., :, None] - loc[..., None, :] + between
    cs = span[..., tile, 0] + loc
    after = tot.flip(-1).cumsum(-1).flip(-1)           # a over tiles t..nt-1
    rest = after[..., tile] - loc
    return seg, cs, rest


def _causal_decay(seg: torch.Tensor) -> torch.Tensor:
    """L_ij = exp(seg_ij) at or below the diagonal, 0 above it (a select:
    above it the exponent may overflow)."""
    Lc = seg.shape[-1]
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=seg.device).tril()
    return torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)


def chunk_dstates_ref(dy, Cm, a):
    """Backward stage 1: dS (B, H, nc, hd, N) float32, the gradient that
    chunk c's output sends to the state the chunk starts from,
    dS_c = dy^T (C o exp(cs)) per chunk."""
    H, Lc = dy.shape[1], dy.shape[3]
    Ch = _heads(Cm.float(), H // Cm.shape[1])
    _, cs, _ = _decays(a, Lc)
    return torch.einsum("bhclp,bhcln->bhcpn", dy.float(),
                        Ch * torch.exp(cs)[..., None])


def state_pass_bwd_ref(dstates, starts, totals):
    """Backward stage 2, the reverse state pass: Q (B, H, nc, hd, N), the
    gradient reaching the state chunk c ends in (Q_c = R_{c+1}, R_nc = 0,
    R_c = dS_c + exp(T_c) R_{c+1}), and dT (B, H, nc) = exp(T_c)
    <R_{c+1}, S_c>, the gradient of the chunk's total of a through the
    carried state."""
    R = torch.zeros_like(dstates[:, :, 0])
    Q, dT = [], []
    for c in reversed(range(dstates.shape[2])):
        k = torch.exp(totals[:, :, c])
        Q.append(R)
        dT.append(k * (R * starts[:, :, c].float()).sum((-2, -1)))
        R = dstates[:, :, c] + k[..., None, None] * R
    return torch.stack(Q[::-1], dim=2), torch.stack(dT[::-1], dim=2)


def _scan_bwd_terms(xdt, Bm, Cm, a, starts, Q, dy):
    """dx, dB and dC per head (the formulas in the module's docstring) and
    the pieces dcs is built from: cb (C_i.B_j), gx (dy_i.x_j), L, the
    decays wq = exp(T - cs_j) and wc = exp(cs_i), and Q_c B_j."""
    H, Lc = xdt.shape[1], xdt.shape[3]
    x, g = xdt.float(), dy.float()
    Bh = _heads(Bm.float(), H // Bm.shape[1])
    Ch = _heads(Cm.float(), H // Cm.shape[1])
    S = starts.float()
    seg, cs, rest = _decays(a, Lc)
    L = _causal_decay(seg)                             # [i, j]
    cb = torch.einsum("bhcin,bhcjn->bhcij", Ch, Bh)
    gx = torch.einsum("bhcip,bhcjp->bhcij", g, x)
    wq = torch.exp(rest)[..., None]                    # exp(T - cs_j)
    wc = torch.exp(cs)[..., None]                      # exp(cs_i)
    QB = torch.einsum("bhcpn,bhcjn->bhcjp", Q, Bh)     # Q_c B_j
    dx = torch.einsum("bhcij,bhcip->bhcjp", cb * L, g) + wq * QB
    dB = torch.einsum("bhcij,bhcin->bhcjn", gx * L, Ch) + \
        wq * torch.einsum("bhcpn,bhcjp->bhcjn", Q, x)
    dC = torch.einsum("bhcij,bhcjn->bhcin", gx * L, Bh) + \
        wc * torch.einsum("bhcpn,bhcip->bhcin", S, g)
    return dx, dB, dC, (cb, gx, L, wq, wc, QB, Ch, S)


def chunk_scan_bwd_ref(xdt, Bm, Cm, a, starts, Q, dT, dy):
    """Backward stage 3: per head, dx (B, H, nc, Lc, hd), dB and dC (B, H,
    nc, Lc, N) and da (B, H, nc, Lc), float32, from the formulas in the
    module's docstring; dcs through the rows and columns of M, as they
    are written."""
    x, g = xdt.float(), dy.float()
    dx, dB, dC, (cb, gx, L, wq, wc, QB, Ch, S) = _scan_bwd_terms(
        xdt, Bm, Cm, a, starts, Q, dy)
    M = cb * gx * L
    y_off = wc * torch.einsum("bhcin,bhcpn->bhcip", Ch, S)
    W = (wq * QB * x).sum(-1)
    dcs = M.sum(-1) - M.sum(-2) + (g * y_off).sum(-1) - W
    dcs[..., -1] += W.sum(-1) + dT
    da = dcs.flip(-1).cumsum(-1).flip(-1)
    return dx, dB, dC, da


def pass_slices(entries: int) -> int:
    """Slices of ``PASS_SLICE`` entries the reverse pass cuts a state of
    ``entries`` into."""
    return -(-entries // PASS_SLICE)


def state_pass_bwd_sliced_ref(dstates, starts, totals):
    """Backward stage 2 as the kernel cuts it: Q as ``state_pass_bwd_ref``
    and partials (B, H, slices, nc), slice s's share of the end-state
    product <Q_c, S_{c+1}> over the entries [PASS_SLICE s, PASS_SLICE (s
    + 1)) of the flattened (hd, N) state (0 for the last chunk).  Their
    sum over the slices is dT_c + <Q_c, s_c>."""
    B, H, nc, hd, N = dstates.shape
    Q, _ = state_pass_bwd_ref(dstates, starts, totals)
    nxt = torch.zeros_like(starts, dtype=torch.float32)
    nxt[:, :, :-1] = starts[:, :, 1:].float()
    prod = (Q * nxt).reshape(B, H, nc, hd * N)
    k = pass_slices(hd * N)
    prod = F.pad(prod, (0, k * PASS_SLICE - hd * N))
    partials = prod.reshape(B, H, nc, k, PASS_SLICE).sum(-1)
    return Q, partials.transpose(2, 3).contiguous()


def dcs_ref(xdt, dx, dy, y):
    """dcs_i = dy_i.y_i - x_i.dx_i (B, H, nc, Lc): the gradient through
    cs in its closed form, the end-state product not added."""
    return (dy.float() * y.float()).sum(-1) - (xdt.float() * dx).sum(-1)


def chunk_scan_bwd_rows_ref(xdt, Bm, Cm, a, starts, Q, dy, y):
    """Backward stage 3 as the kernel computes it: dx, dB and dC per head
    (as ``chunk_scan_bwd_ref``) and dcs from ``dcs_ref`` on the forward's
    output ``y``, with no M."""
    dx, dB, dC, _ = _scan_bwd_terms(xdt, Bm, Cm, a, starts, Q, dy)
    return dx, dB, dC, dcs_ref(xdt, dx, dy, y)


def da_ref(dcs, partials):
    """Backward stage 4: da_k = sum_{i>=k} dcs_i inside each chunk, the
    end-state product (``partials`` summed over its slices in order) added
    on the chunk's last row."""
    v = dcs.clone()
    v[..., -1] += partials.sum(2)
    return v.flip(-1).cumsum(-1).flip(-1)


def group_sum_ref(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, H, ...) per head -> (B, G, ...) per group: the heads h with
    h // (H // G) = g summed, in order."""
    B, H = t.shape[:2]
    return t.reshape(B, G, H // G, *t.shape[2:]).sum(2)


def ssd_bwd_ref(xdt, Bm, Cm, a, starts, dy):
    """The backward of the chunk scan from a zero state: the gradients
    (dxdt, dBm, dCm, da) of the loss for the output cotangent ``dy`` (B,
    H, nc, Lc, hd), float32, dBm and dCm per group.  ``starts`` (B, H,
    nc, hd, N) is what the forward's state pass writes (the state each
    chunk starts from)."""
    G = Bm.shape[1]
    _, totals = chunk_states_ref(xdt, Bm, a)
    Q, dT = state_pass_bwd_ref(chunk_dstates_ref(dy, Cm, a), starts, totals)
    dx, dB, dC, da = chunk_scan_bwd_ref(xdt, Bm, Cm, a, starts, Q, dT, dy)
    return dx, group_sum_ref(dB, G), group_sum_ref(dC, G), da


def ssd_bwd_stages_ref(xdt, Bm, Cm, a, starts, dy, y):
    """The backward as the kernels cut it, each stage its plain version:
    ``chunk_dstates_ref``, ``state_pass_bwd_sliced_ref``,
    ``chunk_scan_bwd_rows_ref`` (dcs closed, from the forward's output
    ``y``), ``da_ref`` and ``group_sum_ref``; (dxdt, dBm, dCm, da) as
    ``ssd_bwd_ref``."""
    G = Bm.shape[1]
    _, totals = chunk_states_ref(xdt, Bm, a)
    Q, partials = state_pass_bwd_sliced_ref(chunk_dstates_ref(dy, Cm, a),
                                            starts, totals)
    dx, dB, dC, dcs = chunk_scan_bwd_rows_ref(xdt, Bm, Cm, a, starts, Q, dy,
                                              y)
    return (dx, group_sum_ref(dB, G), group_sum_ref(dC, G),
            da_ref(dcs, partials))
