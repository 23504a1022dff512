"""The backward of the port's SSD chunk scan on the CPU against the JAX
package: the plain backward (``ref.ssd_bwd_ref``) and each of its stages
against ``jax.vjp`` of JAX's ``ssd_ref`` (the recurrence), of
``repro.models.mamba2.ssd_chunk_scan`` from a zero state, and of jnp
forms of each stage; the plain stages as the kernels cut them
(``ssd_bwd_stages_ref``) against those and the same references; ``SSDScan`` (which runs the plain stages for CPU
tensors) against ``torch.autograd`` of the port's ``ssd_ref`` through
strided views of the model's layout; and ``mamba_apply``'s gradients
against ``jax.grad`` of JAX's.

The same numpy draws go to both frameworks.  Tolerance: float32
gradients within 1e-5 of each tensor's max |grad| (the frameworks sum in
other orders; the recurrence and the chunked form differ by their
roundoff).  A gradient returned in bfloat16 is a rounding of its float32
value, so two of them may differ by one bfloat16 step, at most 2^-7 of
the tensor's max |grad|: that is their limit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7

#: (H, G, Lc, hd, N): one group and two, one 64-row tile and several (a
#: ragged last one at Lc = 130 would not divide S; 128 is two whole
#: tiles), widths the kernels pad (hd to 4, N to 4 or 8).
CASES = [(2, 1, 16, 10, 6), (4, 2, 16, 10, 6), (2, 1, 128, 8, 12),
         (4, 2, 128, 6, 5)]


def _draw(seed, B, H, G, nc, Lc, hd, N, bdtype):
    """numpy xdt, Bm, Cm (per group), a = -softplus(N(0, 1)) and dy, with
    B and C rounded to ``bdtype`` (float32 or bfloat16)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, nc, Lc, hd)) * 0.5).astype(np.float32)
    b, c = ((rng.standard_normal((B, G, nc, Lc, N)) * 0.5).astype(np.float32)
            for _ in range(2))
    if bdtype == "bfloat16":
        b, c = (torch.from_numpy(t).bfloat16().float().numpy() for t in (b, c))
    a = -np.logaddexp(rng.standard_normal((B, H, nc, Lc)), 0.0).astype(
        np.float32)
    dy = rng.standard_normal((B, H, nc, Lc, hd)).astype(np.float32)
    return x, b, c, a, dy


def _rel(got, ref) -> float:
    got, ref = (np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                           np.float64) for v in (got, ref))
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _heads(t, H):
    return jnp.repeat(t, H // t.shape[1], axis=1)


def _j_chunk(x, Bh, Ch, a, S):
    """JAX jnp form of one chunk's pieces: y from the state S the chunk
    starts from, the chunk's own state s and its total T of a."""
    Lc = a.shape[-1]
    cs = jnp.cumsum(a, -1)
    mask = jnp.tril(jnp.ones((Lc, Lc), bool))
    seg = cs[..., :, None] - cs[..., None, :]
    L = jnp.where(mask, jnp.exp(jnp.where(mask, seg, 0.0)), 0.0)
    y = jnp.einsum("bhcin,bhcjn,bhcij,bhcjp->bhcip", Ch, Bh, L, x) + \
        jnp.einsum("bhcin,bhcpn->bhcip", Ch, S) * jnp.exp(cs)[..., None]
    T = cs[..., -1]
    s = jnp.einsum("bhcjp,bhcjn->bhcpn", x,
                   Bh * jnp.exp(T[..., None] - cs)[..., None])
    return y, s, T


def _j_starts(states, totals):
    """JAX's state recurrence: the state each chunk starts from."""
    S = jnp.zeros_like(states[:, :, 0])
    out = []
    for c in range(states.shape[2]):
        out.append(S)
        S = S * jnp.exp(totals[:, :, c])[..., None, None] + states[:, :, c]
    return jnp.stack(out, axis=2)


@jax.jit
def _j_refs(x, b, c, a, dy, starts, states, totals, dS, Q, dT):
    """Every JAX reference of one case in one compiled function: the vjp
    of ``ssd_ref`` (the recurrence, B and C per head), of
    ``ssd_chunk_scan`` (the chunked form, model layout) from a zero
    state, and of each stage's jnp form at the port's intermediate
    values: y_off for dS, the state recurrence for (Q, dT), one chunk's
    pieces with S held fixed for the chunk scan (per head)."""
    B, H, nc, Lc, hd = x.shape
    N = b.shape[-1]
    bh, ch = _heads(b, H), _heads(c, H)
    rec = jax.vjp(j_ssd_ref, x, bh, ch, a)[1](dy)

    def chunked(x, b, c, a):
        def lay(t):                                      # heads after Lc
            return jnp.moveaxis(t, 1, 3)
        y, _ = JMB.ssd_chunk_scan(lay(x), lay(b), lay(c), lay(a),
                                  jnp.zeros((B, H, hd, N), jnp.float32))
        return jnp.moveaxis(y, 3, 1)
    form = jax.vjp(chunked, x, bh, ch, a)[1](dy)
    ds = jax.vjp(lambda S: _j_chunk(x, bh, ch, a, S)[0], starts)[1](dy)[0]
    qt = jax.vjp(_j_starts, states, totals)[1](dS)
    scan = jax.vjp(lambda x, bh, ch, a: _j_chunk(x, bh, ch, a, starts), x,
                   bh, ch, a)[1]((dy, Q, dT))
    return rec, form, ds, qt, scan


@pytest.mark.parametrize("bdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Lc,hd,N", CASES)
def test_plain_backward_equals_jax_vjp(H, G, Lc, hd, N, bdtype):
    """``ssd_bwd_ref`` against ``jax.vjp`` of JAX's ``ssd_ref`` and of
    ``ssd_chunk_scan`` from a zero state (dB and dC summed over each
    group's heads); then each stage against the vjp of its jnp form on
    the same inputs (``_j_refs``)."""
    B, nc = 2, 2
    x, b, c, a, dy = _draw(Lc + hd + N + H, B, H, G, nc, Lc, hd, N, bdtype)
    t = [torch.from_numpy(v) for v in (x, b, c, a, dy)]
    tb, tc = (v.to(getattr(torch, bdtype)) for v in t[1:3])
    states, totals = sref.chunk_states_ref(t[0], tb, t[3])
    starts = sref.state_pass_ref(states, totals)
    got = sref.ssd_bwd_ref(t[0], tb, tc, t[3], starts, t[4])
    dS = sref.chunk_dstates_ref(t[4], tc, t[3])
    Q, dT = sref.state_pass_bwd_ref(dS, starts, totals)
    dx, dBh, dCh, da = sref.chunk_scan_bwd_ref(t[0], tb, tc, t[3], starts,
                                               Q, dT, t[4])
    rec, form, jdS, (jQ, jdT), scan = _j_refs(*map(jnp.asarray, (
        x, b, c, a, dy, starts, states, totals, dS, Q, dT)))

    def per_group(g):
        return np.asarray(g).reshape(B, G, H // G, *g.shape[2:]).sum(2)
    names = ("dx", "dB", "dC", "da")
    for ref in (rec, form):
        ref = (ref[0], per_group(ref[1]), per_group(ref[2]), ref[3])
        for name, g, r in zip(names, got, ref):
            assert _rel(g, r) <= F32_TOL, name
    assert _rel(dS, jdS) <= F32_TOL
    assert _rel(Q, jQ) <= F32_TOL and _rel(dT, jdT) <= F32_TOL
    for name, g, r in zip(names, (dx, dBh, dCh, da), scan):
        assert _rel(g, r) <= F32_TOL, name
    for g, r in ((sref.group_sum_ref(dBh, G), per_group(scan[1])),
                 (sref.group_sum_ref(dCh, G), per_group(scan[2]))):
        assert _rel(g, r) <= F32_TOL


@pytest.mark.parametrize("bdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Lc,hd,N", CASES)
def test_kernel_stages_equal_the_plain_chain_and_jax(H, G, Lc, hd, N,
                                                     bdtype):
    """The plain versions of the stages as the kernels cut them: the
    sliced reverse pass (Q as ``state_pass_bwd_ref``, its per-slice
    shares of <Q_c, S_{c+1}> summing to dT_c + <Q_c, s_c>), dcs in its
    closed form with ``da_ref`` (equal to the M form's da), and their
    composition ``ssd_bwd_stages_ref`` against ``ssd_bwd_ref`` and
    ``jax.vjp`` of ``ssd_ref`` and ``ssd_chunk_scan``.  A state of more
    than ``PASS_SLICE`` entries is cut into several slices."""
    B, nc = 2, 2
    if N * hd <= sref.PASS_SLICE:       # several slices: widen the state
        N = N * (sref.PASS_SLICE // (N * hd) + 1)
    x, b, c, a, dy = _draw(Lc + hd + N + H + 1, B, H, G, nc, Lc, hd, N,
                           bdtype)
    t = [torch.from_numpy(v) for v in (x, b, c, a, dy)]
    tb, tc = (v.to(getattr(torch, bdtype)) for v in t[1:3])
    states, totals = sref.chunk_states_ref(t[0], tb, t[3])
    starts = sref.state_pass_ref(states, totals)
    y = sref.chunk_scan_ref(t[0], tb, tc, t[3], starts)
    dS = sref.chunk_dstates_ref(t[4], tc, t[3])
    Q, dT = sref.state_pass_bwd_ref(dS, starts, totals)
    Qs, partials = sref.state_pass_bwd_sliced_ref(dS, starts, totals)
    assert partials.shape == (B, H, sref.pass_slices(hd * N), nc)
    assert partials.shape[2] > 1 and torch.equal(Qs, Q)
    end = dT + (Q * states).sum((-2, -1))
    assert _rel(partials.sum(2), end) <= F32_TOL
    assert float(partials[..., -1].abs().max()) == 0.0
    dx, dBh, dCh, dcs = sref.chunk_scan_bwd_rows_ref(t[0], tb, tc, t[3],
                                                     starts, Q, t[4], y)
    want = sref.chunk_scan_bwd_ref(t[0], tb, tc, t[3], starts, Q, dT, t[4])
    for g, r in zip((dx, dBh, dCh, sref.da_ref(dcs, partials)), want):
        assert _rel(g, r) <= F32_TOL
    got = sref.ssd_bwd_stages_ref(t[0], tb, tc, t[3], starts, t[4], y)
    rec, form, _, (jQ, jdT), scan = _j_refs(*map(jnp.asarray, (
        x, b, c, a, dy, starts, states, totals, dS, Q, dT)))
    assert _rel(partials.sum(2), np.asarray(jdT) + np.einsum(
        "bhcpn,bhcpn->bhc", np.asarray(jQ), states.numpy())) <= F32_TOL
    assert _rel(sref.da_ref(dcs, partials), scan[3]) <= F32_TOL

    def per_group(g):
        return np.asarray(g).reshape(B, G, H // G, *g.shape[2:]).sum(2)
    plain = sref.ssd_bwd_ref(t[0], tb, tc, t[3], starts, t[4])
    for ref in (rec, form):
        ref = (ref[0], per_group(ref[1]), per_group(ref[2]), ref[3])
        for name, g, r, p in zip(("dx", "dB", "dC", "da"), got, ref, plain):
            assert _rel(g, r) <= F32_TOL, name
            assert _rel(g, p) <= F32_TOL, name


def _model_views(x, b, c, a, G):
    """Leaves in the model's layouts and the kernel's views of them: x (B,
    S, H, hd) and a (B, S, H) float32, B and C slices of one (B, S, 2 G N)
    tensor in their dtype; views (B, H or G, nc, Lc, *)."""
    B, H, nc, Lc, hd = x.shape
    N = b.shape[-1]
    S = nc * Lc
    xl = torch.from_numpy(x).permute(0, 2, 3, 1, 4).reshape(B, S, H, hd)
    al = torch.from_numpy(a).permute(0, 2, 3, 1).reshape(B, S, H)
    bc = torch.cat([torch.from_numpy(v).permute(0, 2, 3, 1, 4).reshape(
        B, S, G * N) for v in (b, c)], -1)
    return xl, al, bc


def _split_views(xl, al, bc, nc, Lc, G, N):
    B, S, H, hd = xl.shape

    def groups(t):
        return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
    return (xl.reshape(B, nc, Lc, H, hd).permute(0, 3, 1, 2, 4),
            groups(bc[..., :G * N]), groups(bc[..., G * N:]),
            al.reshape(B, nc, Lc, H).permute(0, 3, 1, 2))


@pytest.mark.parametrize("bdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Lc,hd,N", CASES[1:3])
def test_ssdscan_on_the_cpu_equals_autograd_of_the_recurrence(
        H, G, Lc, hd, N, bdtype):
    """``ssd_scan_cuda`` with a gradient asked for goes through
    ``SSDScan``, which on CPU tensors pads the operands, runs the plain
    stages, saves what its backward reads and returns the gradients in
    the inputs' dtypes and shapes: through strided views of the model's
    layout, the leaves' gradients equal ``torch.autograd`` of ``ssd_ref``
    on the same leaves, and the output equals the recurrence."""
    B, nc = 2, 2
    x, b, c, a, dy = _draw(7 + Lc, B, H, G, nc, Lc, hd, N, bdtype)
    dt = getattr(torch, bdtype)
    grads, ys = [], []
    for fn in (sk.ssd_scan_cuda, sref.ssd_ref):
        xl, al, bc = _model_views(x, b, c, a, G)
        leaves = [xl.requires_grad_(), al.requires_grad_(),
                  bc.to(dt).requires_grad_()]
        views = _split_views(*leaves, nc, Lc, G, N)
        before = sk.launches.count, sk.bwd_launches.count
        y = fn(*views)
        assert y.shape == (B, H, nc, Lc, hd) and y.dtype == torch.float32
        ys.append(y.detach())
        grads.append(torch.autograd.grad(y, leaves, torch.from_numpy(dy)))
        assert (sk.launches.count, sk.bwd_launches.count) == before
    assert _rel(ys[0], ys[1]) <= F32_TOL
    for g, r in zip(grads[0], grads[1]):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _rel(g, r) <= (BF16_TOL if g.dtype == torch.bfloat16
                              else F32_TOL)


def test_ssdscan_returns_what_its_inputs_need():
    """bfloat16 x and a come back as bfloat16 gradients, a leaf that needs
    none gets none, and without grad mode the call is the recurrence."""
    x, b, c, a, dy = _draw(3, 1, 2, 1, 2, 16, 8, 4, "float32")
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    at = torch.from_numpy(a).bfloat16()
    bt, ct = torch.from_numpy(b), torch.from_numpy(c).requires_grad_()
    y = sk.ssd_scan_cuda(xt, bt, ct, at)
    assert y.dtype == torch.bfloat16 and y.requires_grad
    gx, gc = torch.autograd.grad(y, (xt, ct), torch.from_numpy(dy).bfloat16())
    assert gx.dtype == torch.bfloat16 and gc.dtype == torch.float32
    with torch.no_grad():
        plain = sk.ssd_scan_cuda(xt, bt, ct, at)
    assert torch.equal(plain, sref.ssd_ref(xt, bt, ct, at))


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_apply_gradients_equal_jax(groups):
    """``mamba_apply`` at the smoke width (64 tokens, four chunks of 16)
    in float32: the gradients of a fixed projection of its output with
    respect to every mixer parameter and to the input, through
    ``SSDScan``, against ``jax.grad`` of JAX's ``mamba_apply``."""
    jc = j_smoke("mamba2-130m").with_(dtype="float32", ssm_groups=groups)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jm = jax.tree.map(lambda v: v[0], jp["layers"]["p0"]["mixer"])
    tm = tp["layers"][0]["mixer"]
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 64, tc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 64, tc.d_model)).astype(np.float32)

    def j_loss(m, x):
        return (JMB.mamba_apply(m, x, None, jc) * w).sum()
    grad = jax.jit(jax.grad(j_loss, argnums=(0, 1)))
    jgm, jgx = grad(jm, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tm.items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = (MB.mamba_apply(leaves, tx, tc) * torch.from_numpy(w)).sum()
    names = sorted(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    for name, g in zip(names + ["x"], got):
        ref = jgx if name == "x" else jgm[name]
        assert _rel(g, ref) <= F32_TOL, name
