"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) on
the CPU against the JAX package's ``mla_apply`` and ``mla_decode``, at
deepseek-v2-lite-16b's smoke size.

Parameters come from the JAX ``mla_init``; inputs and caches from a numpy
seed.  float32 within 1e-4 decides; bfloat16 within 2e-2 of max."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import rope_tables  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layer(dtype, **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = j_smoke("deepseek-v2-lite-16b").with_(dtype=dtype, **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JMLA.mla_init(jax.random.PRNGKey(2), jc)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(
        DTYPES[dtype][1]) for k, v in jp.items()}
    return jc, tc, jp, tp


def _normal(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype):
    """Prefill: q and k nope || rope (24 wide at smoke size), v at its own
    width (16), through the flash entry point's plain version."""
    jc, tc, jp, tp = _layer(dtype)
    assert tc.qk_nope_dim + tc.qk_rope_dim != tc.v_head_dim
    B, S = 2, 40
    rng = np.random.default_rng(1)
    jx, tx = _normal(rng, (B, S, tc.d_model), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    ref = JMLA.mla_apply(jp, jx, jnp.asarray(pos), jc)
    rope = rope_tables(torch.from_numpy(pos.copy()), tc.qk_rope_dim,
                       tc.rope_theta)
    got = TMLA.mla_apply(tp, tx, rope, tc)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(absorb, dtype):
    """One batched decode step over a filled latent cache of C = 12 slots,
    rows at positions 0, 5, 11, C and C + 3: each row equals JAX's
    single-row ``mla_decode`` (the engine's vmap), the write at ``pos >= C``
    clamped to the last slot as JAX's ``dynamic_update_slice`` clamps it,
    and the cache is written in place."""
    jc, tc, jp, tp = _layer(dtype, mla_absorb=absorb)
    C = 12
    pos = np.array([0, 5, 11, C, C + 3], np.int32)
    B = len(pos)
    rng = np.random.default_rng(3)
    jx, tx = _normal(rng, (B, 1, tc.d_model), dtype)
    jc_kv, tc_kv = _normal(rng, (B, C, tc.kv_lora_rank), dtype, 0.5)
    jk_r, tk_r = _normal(rng, (B, C, tc.qk_rope_dim), dtype, 0.5)
    cache = TMLA.MLACache(tc_kv.clone(), tk_r.clone(),
                          torch.zeros((), dtype=torch.int32))
    rope = rope_tables(torch.from_numpy(pos)[:, None], tc.qk_rope_dim,
                       tc.rope_theta)
    got, new = TMLA.mla_decode(tp, tx, torch.from_numpy(pos), rope, cache,
                               tc)
    assert new.c_kv is cache.c_kv and new.k_rope is cache.k_rope
    assert int(new.length) == C + 4
    for b in range(B):
        one = JMLA.MLACache(jc_kv[b:b + 1], jk_r[b:b + 1],
                            jnp.zeros((), jnp.int32))
        ref, jnew = JMLA.mla_decode(jp, jx[b:b + 1], jnp.asarray(pos[b]),
                                    one, jc)
        _close(got[b:b + 1], ref, dtype)
        np.testing.assert_array_equal(new.c_kv[b:b + 1].float().numpy(),
                                      np.asarray(jnew.c_kv, np.float32))
        np.testing.assert_array_equal(new.k_rope[b:b + 1].float().numpy(),
                                      np.asarray(jnew.k_rope, np.float32))
    # the rows past the cache wrote its last slot and left the others
    changed = (new.c_kv != tc_kv).any(-1)
    assert changed[3].tolist() == [False] * (C - 1) + [True]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_equals_decompressed(dtype):
    """The two decode forms compute one function: w_uk folded into the
    query and w_uv into the output, against decompressing the cache."""
    _, tc, _, tp = _layer(dtype)
    C, pos = 10, np.array([2, 9, 14], np.int32)
    rng = np.random.default_rng(4)
    _, tx = _normal(rng, (3, 1, tc.d_model), dtype)
    _, c_kv = _normal(rng, (3, C, tc.kv_lora_rank), dtype, 0.5)
    _, k_r = _normal(rng, (3, C, tc.qk_rope_dim), dtype, 0.5)
    rope = rope_tables(torch.from_numpy(pos)[:, None], tc.qk_rope_dim,
                       tc.rope_theta)
    outs = []
    for cfg in (tc, tc.with_(mla_absorb=True)):
        cache = TMLA.MLACache(c_kv.clone(), k_r.clone(),
                              torch.zeros((), dtype=torch.int32))
        outs.append(TMLA.mla_decode(tp, tx, torch.from_numpy(pos), rope,
                                    cache, cfg)[0])
    _close(outs[1], outs[0].float().numpy(), dtype)


def test_init_keeps_jax_w_uk_equal_to_w_uv():
    """JAX draws w_uk and w_uv from one key: equal when qk_nope_dim ==
    v_head_dim (the smoke and full deepseek configs), drawn apart
    otherwise."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    assert cfg.qk_nope_dim == cfg.v_head_dim
    gen = torch.Generator().manual_seed(0)
    p = TMLA.mla_init(cfg, gen, "cpu", torch.float32)
    assert torch.equal(p["w_uk"], p["w_uv"])
    assert p["w_uk"].data_ptr() != p["w_uv"].data_ptr()
    jp = JMLA.mla_init(jax.random.PRNGKey(0), cfg)
    np.testing.assert_array_equal(np.asarray(jp["w_uk"]),
                                  np.asarray(jp["w_uv"]))
    wide = cfg.with_(v_head_dim=24)
    p = TMLA.mla_init(wide, gen, "cpu", torch.float32)
    assert p["w_uv"].shape == (wide.kv_lora_rank, wide.num_heads * 24)
    for name, x in p.items():
        assert x.shape == tuple(np.asarray(
            JMLA.mla_init(jax.random.PRNGKey(0), wide)[name]).shape)
