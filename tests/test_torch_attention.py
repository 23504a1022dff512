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
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
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
