"""The port's attention kernels' plain versions and entry points on the CPU
against the JAX package's Pallas kernels (interpret mode) and references.

On CPU tensors the wrappers run the plain versions, so these tests pin the
arithmetic that ``tests/test_torch_kernels_cuda.py`` then holds the CUDA
kernels to on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.decode_attention import \
    decode_attention as j_decode  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as j_decode_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as da  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, merge_partials, share_bounds, share_partials)
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref, visible)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shapes, dtype):
    """The same normal draws in both frameworks, rounded to ``dtype``
    identically (round to nearest even)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _close(got, ref, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("S,hd,dtype,window", [
    (128, 64, "float32", 0),
    (256, 64, "float32", 0),
    (256, 128, "float32", 64),
    (256, 32, "bfloat16", 0),
    (512, 64, "bfloat16", 128),
])
def test_attention_matches_jax_flash_kernel(S, hd, dtype, window):
    B, H, KV = 2, 4, 2
    (jq, jk, jv), (q, k, v) = _inputs(S + hd, [(B, H, S, hd), (B, KV, S, hd),
                                               (B, KV, S, hd)], dtype)
    ref = j_flash(jq, jk, jv, causal=True, window=window, bq=128, bk=128,
                  interpret=True)
    before = fa.launches.count
    _close(attention_ref(q, k, v, causal=True, window=window), ref, dtype)
    _close(attention(q, k, v, causal=True, window=window), ref, dtype)
    assert fa.launches.count == before      # CPU tensors launch nothing
    _close(attention_ref(q, k, v, causal=False),
           j_attention_ref(jq, jk, jv, causal=False), dtype)


@pytest.mark.parametrize("S,hd,dtype,window", [
    (128, 64, "float32", 0),
    (256, 32, "bfloat16", 64),
])
def test_attention_lse_ref_matches_jax(S, hd, dtype, window):
    """The plain version of what the forward kernel saves for its
    backward: each row's log-sum-exp equals ``jax.nn.logsumexp`` of JAX's
    scaled, masked scores, and exp(s - lse) @ v equals JAX's flash kernel
    (interpret mode), at the flash tolerances."""
    B, H, KV = 2, 4, 2
    (jq, jk, jv), (q, k, v) = _inputs(S + hd + 1, [
        (B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)], dtype)
    out, lse = attention_lse_ref(q, k, v, causal=True, window=window)
    assert out.dtype == q.dtype and lse.shape == (B, H, S)
    assert lse.dtype == torch.float32
    _close(out, j_flash(jq, jk, jv, causal=True, window=window, bq=128,
                        bk=128, interpret=True), dtype)
    s = jnp.einsum("bhqd,bhkd->bhqk", jq.astype(jnp.float32),
                   jnp.repeat(jk, H // KV, axis=1).astype(jnp.float32))
    s = jnp.where(jnp.asarray(visible(S, S, True, window).numpy()),
                  s * hd**-0.5, -1e30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(s, axis=-1)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("C,pos,window,dtype", [
    (256, 0, 0, "float32"),
    (256, 255, 0, "float32"),
    (512, 300, 0, "bfloat16"),
    (512, 300, 128, "float32"),
])
def test_decode_attention_matches_jax_decode_kernel(C, pos, window, dtype):
    B, H, KV, hd = 2, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(C + pos, [(B, H, hd), (B, KV, C, hd),
                                                (B, KV, C, hd)], dtype)
    ref = j_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32), bc=128,
                   window=window, interpret=True)
    before = da.launches.count
    _close(decode_attention_ref(q, k, v, pos, window=window), ref, dtype)
    per_row = torch.full((B,), pos, dtype=torch.int32)
    _close(decode_attn(q, k, v, per_row, window=window), ref, dtype)
    assert da.launches.count == before


@pytest.mark.parametrize("window", [0, 40])
def test_per_row_positions_equal_jax_row_by_row(window):
    """One position per row is the TPU kernel's scalar position applied to
    each row on its own (the serving engine's vmap)."""
    B, H, KV, C, hd = 4, 8, 2, 256, 32
    pos = [0, 37, 130, 255]
    (jq, jk, jv), (q, k, v) = _inputs(7, [(B, H, hd), (B, KV, C, hd),
                                          (B, KV, C, hd)], "float32")
    got = decode_attn(q, k, v, torch.tensor(pos, dtype=torch.int32),
                      window=window)
    for b, p in enumerate(pos):
        ref = j_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                       jnp.asarray(p, jnp.int32), bc=64, window=window,
                       interpret=True)
        _close(got[b:b + 1], ref, "float32")
        _close(got[b:b + 1], j_decode_ref(jq[b:b + 1], jk[b:b + 1],
                                          jv[b:b + 1], p, window=window),
               "float32")


def test_nothing_valid_gives_the_mean_of_v():
    """A row with no valid slot (every score at -1e30) averages v over the
    whole cache, as the TPU kernel does; a scalar pos is broadcast."""
    (jq, jk, jv), (q, k, v) = _inputs(3, [(2, 4, 16), (2, 2, 64, 16),
                                          (2, 2, 64, 16)], "float32")
    got = decode_attn(q, k, v, torch.tensor([-1, 200], dtype=torch.int32),
                      window=16)
    mean = v.mean(2).repeat_interleave(2, dim=1)
    np.testing.assert_allclose(got.numpy(), mean.numpy(), atol=1e-6)
    ref = j_decode(jq, jk, jv, jnp.asarray(-1, jnp.int32), bc=32,
                   interpret=True)
    _close(decode_attn(q, k, v, -1), ref, "float32")


@pytest.mark.parametrize("pos,window,shares", [
    ((0, 37, 130, 255), 0, 8),      # ragged; row 0's valid row in one share
    ((200, 255, 9, 64), 40, 3),     # a window, shares off the row count
    ((-1, 255, -1, 5), 0, 4),       # nothing valid in rows 0 and 2
    ((3, 3, 3, 3), 16, 8),          # shares with no valid row
    ((255, 100, 50, 0), 0, 1),      # one share: the single-block form
])
def test_share_merge_equals_the_whole_softmax(pos, window, shares):
    """The decode kernel's split over the cache and its combine (per-share
    (m, l, acc), then m = max m_i, weights exp(m_i - m)) give the plain
    softmax and JAX's kernel, the TPU's -1e30 cases included: an empty
    share weighs 0, and a row with nothing valid averages v over the
    cache."""
    B, H, KV, C, hd = 4, 8, 2, 256, 32
    (jq, jk, jv), (q, k, v) = _inputs(shares + window, [
        (B, H, hd), (B, KV, C, hd), (B, KV, C, hd)], "float32")
    p = torch.tensor(pos, dtype=torch.int32)
    bounds = share_bounds(p, C, window, shares)
    assert bounds.shape == (shares, B, 2)
    sizes = bounds[..., 1] - bounds[..., 0] + 1
    assert bool((sizes >= 0).all())
    m, l, acc = share_partials(q, k, v, p, window=window, shares=shares)
    got = merge_partials(m, l, acc).reshape(B, H, hd)
    _close(got, decode_attention_ref(q, k, v, p, window=window).numpy(),
           "float32")
    for b, pb in enumerate(pos):
        ref = j_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                       jnp.asarray(pb, jnp.int32), bc=64, window=window,
                       interpret=True)
        _close(got[b:b + 1], ref, "float32")
        empty = sizes[:, b] == 0
        if bool(empty.any()):            # an empty share keeps the -1e30 state
            assert bool((m[empty, b] == -1e30).all())
            assert bool((l[empty, b] == 0).all())
        if pb < 0:                       # nothing valid: the mean of v
            mean = v[b].mean(1).repeat_interleave(H // KV, dim=0)
            np.testing.assert_allclose(got[b].numpy(), mean.numpy(),
                                       atol=1e-6)


def test_gqa_equals_mha_with_repeated_kv():
    B, H, S, hd = 1, 4, 128, 32
    _, (q, k, v) = _inputs(0, [(B, H, S, hd), (B, 1, S, hd), (B, 1, S, hd)],
                           "float32")
    gqa = attention(q, k, v)
    mha = attention(q, k.repeat(1, H, 1, 1), v.repeat(1, H, 1, 1))
    np.testing.assert_allclose(gqa.numpy(), mha.numpy(), atol=1e-6)
    _, (qd,) = _inputs(1, [(2, H, hd)], "float32")
    kc, vc = k.expand(2, 1, S, hd), v.expand(2, 1, S, hd)
    pos = torch.tensor([5, 127], dtype=torch.int32)
    np.testing.assert_allclose(
        decode_attn(qd, kc, vc, pos).numpy(),
        decode_attn(qd, kc.repeat(1, H, 1, 1), vc.repeat(1, H, 1, 1),
                    pos).numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype,hd,expected", [
    (torch.bfloat16, 128, "tensor-core"),
    (torch.bfloat16, 120, "tensor-core"),
    (torch.bfloat16, 64, "tensor-core"),
    (torch.bfloat16, 16, "tensor-core"),
    (torch.bfloat16, 192, "cuda-core"),
    (torch.float32, 128, "cuda-core"),
    (torch.float32, 64, "cuda-core"),
])
def test_flash_dispatch_is_by_dtype_and_width(dtype, hd, expected):
    """bf16 with hd <= 128 runs on the tensor cores; float32 (whose 1e-4
    gate TF32 would not hold) and wider heads on the CUDA cores."""
    assert fa.instance(dtype, hd) == expected


def test_flash_reads_the_models_views_through_their_strides():
    """The model's (B, S, H, hd) projections, transposed to (B, H, S, hd),
    go to the tensor-core instance as they are: TMA takes their strides.
    A view whose strides are not whole 16-byte steps, or whose start is
    off the 16-byte grid, is copied instead."""
    B, S, H, hd = 2, 48, 4, 64
    x = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert fa._strides(view) == [H * hd, hd, S * H * hd]
    assert fa._tma_ready(view) is view
    one = torch.zeros(1, S, 1, hd, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._strides(one) == [hd, hd, hd]          # extent-1 dims
    odd = torch.zeros(B, H, S, hd + 4, dtype=torch.bfloat16)[..., :hd]
    copy = fa._tma_ready(odd)
    assert copy is not odd and copy.is_contiguous()
    flat = torch.zeros(B * H * S * hd + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(B, H, S, hd)
    assert shifted.data_ptr() % 16 != 0
    assert fa._tma_ready(shifted).data_ptr() % 16 == 0
    ones = torch.ones(hd, dtype=torch.bfloat16).expand(B, H, S, hd)
    assert fa._tma_ready(ones).is_contiguous()   # a broadcast cotangent


def test_wrappers_check_their_inputs():
    q = torch.zeros(2, 4, 8, 16)
    k = torch.zeros(2, 3, 8, 16)
    with pytest.raises(ValueError, match="H % KV"):
        attention(q, k, k)
    with pytest.raises(ValueError, match="share one of"):
        attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="pos must be"):
        decode_attn(torch.zeros(2, 4, 16), torch.zeros(2, 2, 8, 16),
                    torch.zeros(2, 2, 8, 16), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrower_values_match_jax(dtype):
    """MLA's widths: q and k 24 wide, v 16.  The flash entry point equals
    JAX's chunked attention (which takes v at its own width); the decode
    entry point equals JAX's MLA decode einsums (scores over q . k, then
    p @ v), on a ring-free cache with per-row positions."""
    from repro.models.attention import chunked_attention
    B, H, S, hd, hd_v = 2, 4, 40, 24, 16
    (jq, jk, jv), (q, k, v) = _inputs(
        3, [(B, H, S, hd), (B, H, S, hd), (B, H, S, hd_v)], dtype)
    ref = chunked_attention(*(x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)),
                            causal=True, q_chunk=8, kv_chunk=8)
    got = attention(q, k, v, causal=True)
    assert got.shape == (B, H, S, hd_v)
    _close(got.transpose(1, 2), ref, dtype)
    pos = np.array([0, 17], np.int32)
    got = decode_attn(q[:, :, 0], k, v, torch.from_numpy(pos))
    assert got.shape == (B, H, hd_v)
    s = jnp.einsum("bhd,bhcd->bhc", jq[:, :, 0].astype(jnp.float32),
                   jk.astype(jnp.float32)) * hd ** -0.5
    s = jnp.where(jnp.arange(S)[None, None] <= pos[:, None, None], s, -1e30)
    ref = jnp.einsum("bhc,bhcd->bhd", jax.nn.softmax(s, axis=-1),
                     jv.astype(jnp.float32))
    _close(got, ref.astype(jq.dtype), dtype)
    with pytest.raises(ValueError, match="hd_v <= hd"):
        attention(v, v, k)
    with pytest.raises(ValueError, match="hd_v <= hd"):
        decode_attn(v[:, :, 0], v, k, 0)


@pytest.mark.parametrize("C,window", [(32, 32), (12, 40)])
def test_ring_decode_equals_the_linear_window(C, window):
    """The ring decode's mask: a ring of C <= window slots, slot i holding
    the latest position == i (mod C), attended with ``window=0`` and the
    absolute position, equals the linear cache of every position through
    the window mask, before, at and past the wrap (JAX's stored-position
    mask, src/repro/models/attention.py)."""
    rng = np.random.default_rng(7)
    B, H, KV, hd = 5, 4, 2, 16
    pos = np.array([C - 1, C, C + 3, 2 * C + 5, 3 * C + 1])
    T = int(pos.max()) + 1
    lin_k = torch.from_numpy(rng.standard_normal((B, KV, T, hd)).astype(
        np.float32))
    lin_v = torch.from_numpy(rng.standard_normal((B, KV, T, hd)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    ring_k = torch.zeros(B, KV, C, hd)
    ring_v = torch.zeros(B, KV, C, hd)
    for b, p in enumerate(pos):
        for t in range(max(0, p - C + 1), p + 1):
            ring_k[b, :, t % C] = lin_k[b, :, t]
            ring_v[b, :, t % C] = lin_v[b, :, t]
    p = torch.from_numpy(pos.astype(np.int32))
    got = decode_attn(q, ring_k, ring_v, p, window=0)
    # the ring holds the last C positions; with C < window the linear
    # window must be cut to C to see the same entries
    ref = decode_attention_ref(q, lin_k, lin_v, p, window=min(C, window))
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=2e-6)


# (B, H, KV, Sq, hd, hd_v, causal, window): causal and windowed, GQA and
# MHA, MLA's hd_v < hd, a window past the sequence, not causal
BWD_CASES = [(2, 4, 2, 48, 16, 16, True, 0),
             (1, 4, 1, 40, 16, 16, True, 12),
             (2, 4, 4, 32, 24, 16, True, 0),
             (1, 6, 2, 36, 16, 8, True, 7),
             (1, 2, 1, 24, 16, 16, False, 0),
             (1, 2, 2, 24, 8, 8, True, 100)]


def _bwd_inputs(seed, B, H, KV, S, hd, hd_v):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v),
                      (B, H, S, hd_v))]


@pytest.mark.parametrize("B,H,KV,S,hd,hd_v,causal,window", BWD_CASES)
def test_attention_bwd_ref_equals_autograd(B, H, KV, S, hd, hd_v, causal,
                                           window):
    """The backward's plain version (explicit formulas, one (batch row, KV
    head) at a time) against torch autograd of ``attention_ref`` and of
    the entry point on CPU tensors, in float32."""
    q, k, v, dout = _bwd_inputs(0, B, H, KV, S, hd, hd_v)
    out = attention_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window)
    for fn in (attention_ref, attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves, causal=causal, window=window).backward(dout)
        for g, leaf in zip(got, leaves):
            assert g.shape == leaf.shape and g.dtype == leaf.dtype
            torch.testing.assert_close(g, leaf.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,KV,S,hd,hd_v,causal,window",
                         [c for c in BWD_CASES if c[6]])
def test_attention_bwd_ref_equals_jax_vjp(B, H, KV, S, hd, hd_v, causal,
                                          window):
    """Against ``jax.vjp`` of JAX's ``chunked_attention`` (the attention JAX
    trains through), K and V expanded to H heads as JAX's ``attn_apply``
    does, whose cotangents are summed back over each KV head's group:
    within 1e-5 of each gradient's max in float32."""
    from repro.models.attention import chunked_attention
    q, k, v, dout = _bwd_inputs(1, B, H, KV, S, hd, hd_v)
    G = H // KV

    def jax_attention(q, k, v):
        k = jnp.repeat(k, G, axis=2)
        v = jnp.repeat(v, G, axis=2)
        return chunked_attention(q, k, v, causal=True, window=window,
                                 q_chunk=4, kv_chunk=4)
    layout = [jnp.asarray(x.transpose(1, 2).numpy()) for x in (q, k, v)]
    out, vjp = jax.vjp(jax_attention, *layout)
    ref = vjp(jnp.asarray(dout.transpose(1, 2).numpy()))
    got = attention_bwd_ref(q, k, v, torch.from_numpy(
        np.asarray(out).transpose(0, 2, 1, 3).copy()), dout, causal=True,
        window=window)
    for g, r in zip(got, ref):
        r = np.asarray(r).transpose(0, 2, 1, 3)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_flash_backward_wrapper_checks_its_inputs():
    """The backward wrapper refuses what its kernels cannot take before
    any launch: a log-sum-exp of another shape or type than the forward's
    (B, H, Sq) float32, a row with no visible key, and CPU tensors (the
    plain version serves them through autograd)."""
    q, k, v, dout = _bwd_inputs(2, 1, 2, 1, 8, 16, 16)
    out, lse = attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    with pytest.raises(ValueError, match="out and dout"):
        fa.flash_attention_bwd_cuda(q, k, v, out[..., :8], dout, lse)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse[:, :1])
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse.double())
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse[..., None])
    assert fa.every_row_sees_a_key(8, 8, 3)
    assert not fa.every_row_sees_a_key(20, 8, 3)
    assert fa.every_row_sees_a_key(20, 8, 0)
    meta = [x.to("meta") for x in (q[:, :, :20], k, v, out, dout)]
    meta[0] = torch.empty(1, 2, 20, 16, device="meta")
    meta[3] = meta[4] = torch.empty(1, 2, 20, 16, device="meta")
    meta.append(torch.empty(1, 2, 20, device="meta"))
    with pytest.raises(NotImplementedError, match="visible key"):
        fa.flash_attention_bwd_cuda(*meta, causal=False, window=3)


@pytest.mark.parametrize("B,H,KV,S,hd,hd_v,causal,window", BWD_CASES)
def test_attention_bwd_ref_with_lse_equals_without(B, H, KV, S, hd, hd_v,
                                                   causal, window):
    """``attention_bwd_ref`` given the forward's log-sum-exp (P = exp(s -
    lse), as the backward kernels form it) gives the gradients it gives
    from the softmax it recomputes, in float32."""
    q, k, v, dout = _bwd_inputs(3, B, H, KV, S, hd, hd_v)
    out, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, out, dout, causal=causal,
                             window=window)
    got = attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window,
                            lse=lse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def _tensor_core_bwd(q, k, v, out, dout, lse, *, window: int):
    """The tensor-core instance's arithmetic in plain PyTorch: float32
    products of the bf16 inputs, P = exp(s - lse) and dS = P (dO V^T - D)
    in float32, each rounded to bf16 before the product that takes it
    (P^T dO, dS K and dS^T Q), the gradients rounded to bf16."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    mask = visible(S, S, True, window)
    qf, dof = q.float(), dout.float()
    kf, vf = (x.float().repeat_interleave(G, 1) for x in (k, v))
    s = (qf @ kf.transpose(-1, -2)) * hd**-0.5
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    d = (dof * out.float()).sum(-1, keepdim=True)
    ds = torch.where(mask, p * (dof @ vf.transpose(-1, -2) - d), 0.0)
    p, ds = (x.bfloat16().float() for x in (p, ds))
    dq = hd**-0.5 * ds @ kf
    dk = hd**-0.5 * (ds.transpose(-1, -2) @ qf).view(B, KV, G, S, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(B, KV, G, S, -1).sum(2)
    return tuple(x.bfloat16() for x in (dq, dk, dv))


def _row_rel(got, ref):
    """chip_smoke.grad_rel_errs's per-row reading: max |diff| / max |ref|
    of each row whose reference is not zero, the largest."""
    a = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    b = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    rows = np.abs(b).max(-1) > 1e-6 * np.abs(b).max()
    return float((np.abs(a - b).max(-1)[rows]
                  / np.abs(b).max(-1)[rows]).max())


@pytest.mark.parametrize("hd,window", [(64, 0), (128, 96)])
def test_tensor_core_rounding_holds_the_bf16_limit(hd, window):
    """The tensor-core backward rounds P and dS to bf16 (the wgmma
    operands); that design, on bf16 inputs at G = 4, stays within the
    bf16 limit of 15a (1e-2 of a row's max) of ``jax.vjp`` of JAX's
    ``chunked_attention`` in float32, so a rounding that could not hold
    it shows here before a card run."""
    from repro.models.attention import chunked_attention
    B, H, KV, S = 1, 8, 2, 256
    G = H // KV
    q, k, v, dout = (x.bfloat16() for x in _bwd_inputs(
        4 + hd, B, H, KV, S, hd, hd))
    out, lse = attention_lse_ref(q.float(), k.float(), v.float(),
                                 window=window)
    got = _tensor_core_bwd(q, k, v, out, dout, lse, window=window)

    def jax_attention(q, k, v):
        k = jnp.repeat(k, G, axis=2)
        v = jnp.repeat(v, G, axis=2)
        return chunked_attention(q, k, v, causal=True, window=window,
                                 q_chunk=64, kv_chunk=64)
    layout = [jnp.asarray(x.float().transpose(1, 2).numpy())
              for x in (q, k, v)]
    _, vjp = jax.vjp(jax_attention, *layout)
    ref = vjp(jnp.asarray(dout.float().transpose(1, 2).numpy()))
    for g, r in zip(got, ref):
        r = np.asarray(r).transpose(0, 2, 1, 3)
        assert g.shape == r.shape
        assert _row_rel(g.float().numpy(), r) <= 1e-2
