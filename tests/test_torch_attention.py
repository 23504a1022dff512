"""The port's attention kernels' plain versions and entry points on the CPU
against the JAX package's Pallas kernels (interpret mode) and references.

On CPU tensors the wrappers run the plain versions, so these tests pin the
arithmetic that ``tests/test_torch_kernels_cuda.py`` then holds the CUDA
kernels to on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402

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
