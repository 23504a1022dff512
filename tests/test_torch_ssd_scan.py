"""The port's SSD chunk-scan plain version and entry point on the CPU
against the JAX package's Pallas kernel (interpret mode), its reference and
its chunked jnp form.

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
