"""The port's SSD chunk-scan plain versions (the recurrence and the three
stages of the kernel) and entry points on the CPU against the JAX
package's Pallas kernel (interpret mode), its reference and its chunked
jnp form.

On CPU tensors the wrapper runs the plain version, so these tests pin the
arithmetic that ``tests/test_torch_kernels_cuda.py`` then holds the CUDA
kernel to on the card.  Tolerances are those of tests/test_kernels.py:
float32 atol 1e-4, bfloat16 atol 5e-2, rtol 1e-2 (the chunked form and
the recurrence sum in other orders); the state-continuity case 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.models.mamba2 import \
    ssd_chunk_scan as j_chunk_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.mamba2 import _heads, ssd_chunk_scan  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, H, nc, Lc, hd, N, dtype, scale=0.5):
    """xdt, Bm, Cm ~ N(0, scale^2) and a = -softplus(N(0, 1)), the same
    draws in both frameworks, rounded to ``dtype`` identically."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [(rng.standard_normal(s) * scale).astype(np.float32)
          for s in ((B, H, nc, Lc, hd), (B, H, nc, Lc, N), (B, H, nc, Lc, N))]
    xs.append(-np.logaddexp(rng.standard_normal((B, H, nc, Lc)), 0.0)
              .astype(np.float32))
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _close(got, ref, atol, rtol=1e-2):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("nc,Lc,hd,N,dtype", [
    (2, 32, 16, 8, "float32"),
    (4, 64, 32, 16, "float32"),
    (4, 64, 64, 32, "bfloat16"),
    (3, 16, 16, 16, "float32"),      # mamba2-130m's smoke widths
])
def test_ssd_matches_jax_kernel_and_reference(nc, Lc, hd, N, dtype):
    B, H = 2, 3
    jin, tin = _inputs(nc * Lc, B, H, nc, Lc, hd, N, dtype)
    kernel = j_ssd(*jin, interpret=True)
    ref = j_ssd_ref(*jin)
    atol = 5e-2 if dtype == "bfloat16" else 1e-4
    before = sk.launches.count
    for got in (ssd_ref(*tin), ssd(*tin), sk.ssd_scan_cuda(*tin)):
        assert got.dtype == tin[0].dtype and got.shape == tin[0].shape
        _close(got, kernel, atol)
        _close(got, ref, atol)
    assert sk.launches.count == before      # CPU tensors launch nothing


def test_ssd_state_continuity_across_chunks():
    """Eight chunks of 16 equal the JAX kernel to 1e-5: the inter-chunk
    state pass is the core of SSD."""
    jin, tin = _inputs(9, 1, 1, 8, 16, 8, 4, "float32", scale=0.3)
    _close(ssd(*tin), j_ssd(*jin, interpret=True), 1e-5, 1e-4)
    _close(ssd(*tin), j_ssd_ref(*jin), 1e-5, 1e-4)


def test_chunk_scan_form_matches_jax_with_final_state():
    """The port's chunked form (``use_kernels=False``) in the model's
    (B, nc, Lc, H, P) layout, from a nonzero state, equals the JAX
    ``ssd_chunk_scan``, final state included, and from a zero state
    equals the plain version of the kernel."""
    B, H, nc, Lc, P, N = 2, 4, 3, 16, 8, 6
    jin, tin = _inputs(4, B, H, nc, Lc, P, N, "float32")
    rng = np.random.default_rng(5)
    s0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)

    def model_layout(t, j):
        perm = (0, 2, 3, 1, 4) if t.ndim == 5 else (0, 2, 3, 1)
        return jnp.transpose(t, perm) if j else t.permute(*perm)
    ref_y, ref_s = j_chunk_scan(*(model_layout(t, True) for t in jin),
                                jnp.asarray(s0))
    y, s = ssd_chunk_scan(*(model_layout(t, False) for t in tin),
                          torch.from_numpy(s0))
    _close(y, ref_y, 1e-5, 1e-4)
    _close(s, ref_s, 1e-5, 1e-4)
    y0, _ = ssd_chunk_scan(*(model_layout(t, False) for t in tin),
                           torch.zeros(B, H, P, N))
    _close(y0.permute(0, 3, 1, 2, 4), ssd_ref(*tin), 1e-4)


def test_group_to_head_mapping_is_repeat_interleave():
    """With G > 1 groups, head h reads group h // (H / G), as
    ``jnp.repeat`` broadcasts them: the entry point, given B and C per
    group in the kernel's (B, G, nc, Lc, N) layout, and the chunked path
    agree on it with the JAX chunked form on per-head copies."""
    B, G, hpg, nc, Lc, P, N = 1, 2, 3, 2, 16, 8, 4
    H = G * hpg
    rng = np.random.default_rng(11)
    grp = rng.standard_normal((B, nc * Lc, G, N)).astype(np.float32)
    np.testing.assert_array_equal(
        _heads(torch.from_numpy(grp), hpg, 2).numpy(),
        np.asarray(jnp.repeat(jnp.asarray(grp), hpg, axis=2)))
    Bg = torch.from_numpy(grp)
    Cg = torch.from_numpy(rng.standard_normal(grp.shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, nc * Lc, H, P))
                         .astype(np.float32))
    a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, nc * Lc, H)).astype(np.float32)))

    def kernel_layout(t):       # (B, S, G, N) -> (B, G, nc, Lc, N)
        return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
    y = ssd(x.reshape(B, nc, Lc, H, P).permute(0, 3, 1, 2, 4),
            kernel_layout(Bg), kernel_layout(Cg),
            a.reshape(B, nc, Lc, H).permute(0, 3, 1, 2))
    jB = jnp.repeat(jnp.asarray(Bg.numpy()), hpg, axis=2)
    jC = jnp.repeat(jnp.asarray(Cg.numpy()), hpg, axis=2)

    def chunk(t):
        return t.reshape(B, nc, Lc, *t.shape[2:])
    ref, _ = j_chunk_scan(chunk(jnp.asarray(x.numpy())), chunk(jB),
                          chunk(jC), chunk(jnp.asarray(a.numpy())),
                          jnp.zeros((B, H, P, N)))
    _close(y.permute(0, 2, 3, 1, 4), ref, 1e-4)


def test_softplus_matches_jax():
    """dt = softplus(dt_raw + dt_bias): torch's (threshold 20) and JAX's
    (logaddexp) agree in float32, across the threshold too."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        np.random.default_rng(0).standard_normal(1000) * 8,
                        [19.99, 20.0, 20.01, -88.0, 88.0]]).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2e-7, atol=1e-30)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(1, 2, 2, 16, 8)
    b = torch.zeros(1, 2, 2, 16, 4)
    a = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="must be"):
        ssd(x[0], b, b, a)
    with pytest.raises(ValueError, match="disagree"):
        ssd(x, b[:, :, :1], b[:, :, :1], a)
    with pytest.raises(ValueError, match="does not divide"):
        g3 = torch.zeros(1, 3, 2, 16, 4)
        ssd(x, g3, g3, a)
    with pytest.raises(ValueError, match="share one of"):
        ssd(x, b.bfloat16(), b, a)
    with pytest.raises(ValueError, match="share one of"):
        ssd(x.half(), b.half(), b.half(), a.half())
    meta = [t.to("meta") for t in (x, b, b, a)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_cuda(*meta)
    for shape_x, shape_b in (((1, 2, 2, 16, 128), (1, 2, 2, 16, 4)),
                             ((1, 2, 2, 16, 8), (1, 2, 2, 16, 256)),
                             ((1, 2, 1, 2048, 8), (1, 2, 1, 2048, 4))):
        xm = torch.zeros(shape_x, device="meta")
        bm = torch.zeros(shape_b, device="meta")
        with pytest.raises(NotImplementedError, match="ssd_scan kernel"):
            sk.ssd_scan_cuda(xm, bm, bm, torch.zeros(shape_x[:4],
                                                     device="meta"))


def _group_inputs(seed, B, H, G, nc, Lc, hd, N, dtype):
    """_inputs with B and C per group for the port, per head (repeated,
    as ``jnp.repeat`` broadcasts them) for the JAX kernel."""
    jin, tin = _inputs(seed, B, H, nc, Lc, hd, N, dtype)
    tin[1], tin[2] = (t[:, ::H // G].contiguous() for t in tin[1:3])
    jin[1], jin[2] = (jnp.repeat(jnp.asarray(t.float().numpy()).astype(
        DTYPES[dtype][0]), H // G, axis=1) for t in tin[1:3])
    return jin, tin


@pytest.mark.parametrize("H,G,nc,Lc,hd,N,dtype", [
    (3, 3, 2, 32, 16, 8, "float32"),
    (3, 3, 4, 64, 32, 16, "float32"),
    (3, 3, 4, 64, 64, 32, "bfloat16"),
    (3, 3, 3, 16, 16, 16, "float32"),
    (4, 2, 3, 16, 16, 16, "float32"),      # two groups of two heads
    (4, 1, 2, 100, 16, 8, "float32"),      # a chunk of one and a half tiles
])
def test_ssd_stages_match_jax_kernel_and_reference(H, G, nc, Lc, hd, N,
                                                   dtype):
    """The plain versions of the kernel's three stages composed (chunk
    states, state pass, chunk scan) equal the JAX kernel and the JAX
    recurrence."""
    B = 2
    jin, tin = _group_inputs(nc * Lc + G, B, H, G, nc, Lc, hd, N, dtype)
    kernel = j_ssd(*jin, interpret=True)
    ref = j_ssd_ref(*jin)
    atol = 5e-2 if dtype == "bfloat16" else 1e-4
    got = sref.ssd_stages_ref(*tin)
    assert got.dtype == tin[0].dtype and got.shape == tin[0].shape
    _close(got, kernel, atol)
    _close(got, ref, atol)


def test_state_pass_matches_the_final_state_of_chunk_scan():
    """The state each chunk starts from (chunk states, then the state
    pass) equals the final state of the port's ``ssd_chunk_scan`` over the
    chunks before it, from a zero state; and a chunk's state alone equals
    that form's final state over that chunk."""
    B, H, G, nc, Lc, P, N = 2, 4, 2, 4, 24, 8, 6
    _, tin = _group_inputs(21, B, H, G, nc, Lc, P, N, "float32")
    x, Bg, Cg, a = tin
    states, totals = sref.chunk_states_ref(x, Bg, a)
    starts = sref.state_pass_ref(states, totals)
    assert not starts[:, :, 0].any()

    def model_layout(t):
        t = sref._heads(t, H // G) if t.shape[1] == G else t
        return t.permute(0, 2, 3, 1, 4) if t.ndim == 5 else \
            t.permute(0, 2, 3, 1)
    xm, Bm, Cm, am = (model_layout(t) for t in tin)
    zero = torch.zeros(B, H, P, N)
    for c in range(1, nc):
        _, final = ssd_chunk_scan(xm[:, :c], Bm[:, :c], Cm[:, :c], am[:, :c],
                                  zero)
        _close(starts[:, :, c], final, 1e-5, 1e-4)
        _, alone = ssd_chunk_scan(xm[:, c:c + 1], Bm[:, c:c + 1],
                                  Cm[:, c:c + 1], am[:, c:c + 1], zero)
        _close(states[:, :, c], alone, 1e-5, 1e-4)
    np.testing.assert_allclose(totals.numpy(), a.sum(-1).numpy(), atol=1e-5,
                               rtol=1e-6)


def test_split_tf32_product_keeps_float32_accuracy():
    """The kernel's split: hi and lo are TF32 values (low 13 mantissa bits
    clear) and hi + lo is v to 2^-20; hi.hi + hi.lo + lo.hi of float32
    operands stays within 1e-6 of max |product| from the float64 product,
    while the single TF32 product hi.hi does not (about 1e-3)."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    Bt = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    (Ah, Al), (Bh, Bl) = sref.split_tf32(A), sref.split_tf32(Bt)
    for part in (Ah, Al, Bh, Bl):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert float(((A - Ah - Al).abs() / A.abs()).max()) < 2.0 ** -20
    exact = A.double() @ Bt.double()
    scale = float(exact.abs().max())
    split = (Al @ Bh + Ah @ Bl) + Ah @ Bh
    single = Ah @ Bh
    assert float((split.double() - exact).abs().max()) <= 1e-6 * scale
    assert float((single.double() - exact).abs().max()) > 1e-4 * scale


def test_operands_are_read_in_the_model_layout():
    """The views mamba_apply passes (x and a of (B, S, H, *), B and C of
    the conv output, bf16 or float32) go to the kernels as they are;
    ragged widths are zero-padded to 16-byte rows and misaligned strides
    copied.  bf16 B and C with float32 x are a valid call."""
    B, S, H, P, G, N, Lc = 2, 64, 4, 8, 1, 16, 32
    nc, din = S // Lc, H * P
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        xbc = torch.from_numpy(rng.standard_normal(
            (B, S, din + 2 * G * N)).astype(np.float32)).to(dtype)
        x = torch.from_numpy(rng.standard_normal((B, S, H, P))
                             .astype(np.float32))
        a = -torch.nn.functional.softplus(torch.from_numpy(
            rng.standard_normal((B, S, H)).astype(np.float32)))

        def groups(t):
            return t.reshape(B, nc, Lc, G, N).permute(0, 3, 1, 2, 4)
        args = (x.reshape(B, nc, Lc, H, P).permute(0, 3, 1, 2, 4),
                groups(xbc[..., din:din + G * N]),
                groups(xbc[..., din + G * N:]),
                a.reshape(B, nc, Lc, H).permute(0, 3, 1, 2))
        for t in args[:3]:
            assert sk.bulk_ready(t)
            assert sk.operand(t, t.shape[-1]).data_ptr() == t.data_ptr()
        assert sk.strides(args[0]) == [S * H * P, P, Lc * H * P, H * P]
        assert sk.strides(args[1])[1] == 0          # one group
        y = ssd(*args)
        _close(y, ssd_ref(args[0], args[1].float(), args[2].float(),
                          args[3]), 1e-6, 1e-6)
    ragged = torch.ones(2, 3, 50)
    padded = sk.operand(ragged, sk.padded_width(50, torch.float32))
    assert padded.shape[-1] == 52 and not padded[..., 50:].any()
    assert sk.padded_width(50, torch.bfloat16) == 56
    odd = torch.ones(2, 3, 9)[..., 1:]              # rows 36 bytes apart
    assert not sk.bulk_ready(odd) and sk.operand(odd, 8).is_contiguous()


def test_stage_wrappers_check_their_operands():
    """The stage wrappers refuse, before any launch, operands whose shapes
    or dtypes the kernels cannot read (meta tensors: not the CPU path)."""
    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    x, b, a = meta(1, 2, 2, 64, 16), meta(1, 1, 2, 64, 8), meta(1, 2, 2, 64)
    starts = meta(1, 2, 2, 16, 8)
    with pytest.raises(ValueError, match="disagree"):
        sk.chunk_states_cuda(x, meta(1, 1, 3, 64, 8), a)
    with pytest.raises(ValueError, match="float32 a"):
        sk.chunk_states_cuda(x, b, a.bfloat16())
    with pytest.raises(ValueError, match="float32 x"):
        sk.chunk_scan_cuda(x.bfloat16(), b, b, a, starts)
    with pytest.raises(ValueError, match="hd % 4"):
        sk.chunk_states_cuda(meta(1, 2, 2, 64, 10), b, a)
    with pytest.raises(ValueError, match="N a multiple of 8"):
        sk.chunk_states_cuda(x, meta(1, 1, 2, 64, 4, dtype=torch.bfloat16),
                             a)
    with pytest.raises(ValueError, match="starts"):
        sk.chunk_scan_cuda(x, b, b, a, meta(1, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="contiguous float32 states"):
        sk.state_pass_cuda(starts.bfloat16(), meta(1, 2, 2))


def test_stage_wrappers_refuse_cpu_tensors():
    """The stage wrappers launch their kernel or raise: CPU tensors are
    refused (only ``ssd_scan_cuda`` runs the plain version for them), and
    nothing is launched."""
    _, (x, b, c, a) = _group_inputs(5, 1, 2, 1, 2, 64, 16, 8, "float32")
    states = torch.zeros(1, 2, 2, 16, 8)
    before = sk.launches.count
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.chunk_states_cuda(x, b, a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.state_pass_cuda(states, torch.zeros(1, 2, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.chunk_scan_cuda(x, b, c, a, states)
    assert sk.launches.count == before
