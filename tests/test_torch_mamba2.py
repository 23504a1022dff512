"""The port's Mamba2 path (mixer, model, converters, serving engine) on the
CPU against the JAX package, on mamba2-130m's smoke config.

Parameters come from the JAX ``init_params`` through
``convert.model_params_from_numpy``; tokens, activations and caches from a
numpy seed.  Tolerances are those of tests/test_torch_models.py: float32
within 1e-4 (abs and rel), bfloat16 within 2e-2 of the reference's max abs
value."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (mamba_caches_from_numpy,  # noqa: E402
                                 mamba_caches_to_numpy,
                                 model_params_from_numpy)
from repro_torch.core.quantize import RES  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as sk  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "mamba2-130m"


def _pair(dtype="float32", **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = j_smoke(ARCH).with_(dtype=dtype, **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _close(got, ref, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def _layer0(jp, tp):
    """The first layer's mixer parameters in both packages."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["p0"]["mixer"]),
            tp["layers"][0]["mixer"])


def _act(rng, shape, dtype):
    x = (rng.standard_normal(shape)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_jax(dtype, groups):
    """The mixer over 64 tokens (four chunks of 16) through the kernel's
    entry point and through the chunked form; ``groups=2`` maps 8 heads
    onto 2 groups of B and C."""
    jc, tc, jp, tp = _pair(dtype, ssm_groups=groups)
    jm, tm = _layer0(jp, tp)
    jx, tx = _act(np.random.default_rng(groups), (2, 64, tc.d_model), dtype)
    ref = JMB.mamba_apply(jm, jx, None, jc)
    before = sk.launches.count
    for use in (True, False):
        got = MB.mamba_apply(tm, tx, tc, use_kernels=use)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _close(got, ref, dtype)
    assert sk.launches.count == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """One recurrence step from a nonzero conv window and SSM state: the
    output and the new cache, which the port writes in place."""
    jc, tc, jp, tp = _pair(dtype)
    jm, tm = _layer0(jp, tp)
    rng = np.random.default_rng(3)
    B = 3
    jx, tx = _act(rng, (B, 1, tc.d_model), dtype)
    cache = MB.init_mamba_cache(tc, B, "cpu")
    conv = rng.standard_normal(cache.conv.shape).astype(np.float32)
    ssm = (rng.standard_normal(cache.ssm.shape) * 0.5).astype(np.float32)
    cache.conv.copy_(torch.from_numpy(conv))
    cache.ssm.copy_(torch.from_numpy(ssm))
    jcache = JMB.MambaCache(jnp.asarray(conv).astype(jnp.dtype(dtype)),
                            jnp.asarray(ssm), jnp.zeros((), jnp.int32))
    ref, jnew = JMB.mamba_decode(jm, jx, jnp.asarray(0), jcache, jc)
    conv_t, ssm_t = cache.conv, cache.ssm
    got, new = MB.mamba_decode(tm, tx, cache, tc)
    assert new.conv is conv_t and new.ssm is ssm_t     # in place
    assert int(new.length) == 1 == int(jnew.length)
    _close(got, ref, dtype)
    _close(new.conv, jnew.conv, dtype)
    _close(new.ssm, jnew.ssm, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_and_caches_match_jax(dtype):
    """20 decode steps from a JAX-made cache: logits and every layer's conv
    window and SSM state stay within tolerance; the caches round-trip
    through the converters.  In bf16 the logits are held to JAX's float32
    run: the smoke model's logits are small (max 0.56), and JAX's own
    bf16 run is 2.3% of that from its float32 run at one of the 20 steps,
    the port's 1.3%, so two bf16 runs are not held to each other step by
    step; the caches are."""
    jc, tc, jp, tp = _pair(dtype)
    jc32 = jc.with_(dtype="float32")
    B, T = 2, 20
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (B, T)) \
        .astype(np.int32)
    jcache = JM.init_cache(jc, B, 32)
    jcache32 = JM.init_cache(jc32, B, 32)
    cache = mamba_caches_from_numpy(jax.tree.map(np.asarray, jcache), tc,
                                    "cpu")
    assert cache[0].conv.dtype == getattr(torch, dtype)
    assert cache[0].ssm.dtype == torch.float32
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    step32 = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc32, t, pos, c))
    for i in range(T):
        tok, pos = jnp.asarray(toks[:, i:i + 1]), jnp.asarray(i, jnp.int32)
        _, jcache = step(jp, tok, pos, jcache)
        ref, jcache32 = step32(jp, tok, pos, jcache32)
        got, cache = M.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                   i, cache)
        _close(got, ref, dtype)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)["p0"]
    mine = mamba_caches_to_numpy(cache, tc)["p0"]
    for name in ("conv", "ssm"):
        _close(getattr(mine, name), getattr(ref, name), dtype)
    np.testing.assert_array_equal(mine.length, np.asarray(ref.length))
    assert list(mine.length) == [T] * tc.num_layers
    back = mamba_caches_to_numpy(
        mamba_caches_from_numpy({"p0": mine}, tc, "cpu"), tc)["p0"]
    for a, b in zip(back, mine):
        np.testing.assert_array_equal(a, b)


def test_prefill_equals_the_recurrence():
    """forward with the kernel's entry point, and with the chunked form,
    over three chunks equals token-by-token decode (the O(1) recurrence)
    at every position."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 48)))
    caches = M.init_cache(cfg, 2, 48, "cpu")
    steps = []
    for i in range(48):
        out, caches = M.decode_step(params, cfg, toks[:, i:i + 1], i, caches)
        steps.append(out[:, 0])
    rec = torch.stack(steps, 1).numpy()
    for use in (True, False):
        full, _ = M.forward(params, cfg, tokens=toks, use_kernels=use)
        np.testing.assert_allclose(full.numpy(), rec, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(M.prefill(params, cfg, tokens=toks).numpy(),
                               rec[:, -1], atol=1e-4, rtol=1e-4)
    with pytest.raises(AssertionError, match="chunk"):
        M.forward(params, cfg, tokens=toks[:, :40])


def test_converter_keeps_float32_leaves():
    _, tc, _, tp = _pair("bfloat16")
    mixer = tp["layers"][1]["mixer"]
    for name in ("A_log", "D_skip", "dt_bias", "norm_scale"):
        assert mixer[name].dtype == torch.float32, name
    for name in ("w_in", "w_out", "conv_w", "conv_b"):
        assert mixer[name].dtype == torch.bfloat16, name
    assert tp["layers"][1]["mixer_norm"]["scale"].dtype == torch.float32
    nh = tc.ssm_heads
    np.testing.assert_allclose(mixer["A_log"].numpy(),
                               np.log(np.linspace(1, 16, nh)), rtol=1e-6)
    np.testing.assert_allclose(mixer["dt_bias"].numpy(),
                               np.log(np.expm1(0.01)), rtol=1e-6)


def test_init_params_has_the_jax_structure():
    """Port init gives the converted JAX tree's keys, shapes and dtypes,
    and the JAX laws."""
    cfg = get_smoke_config(ARCH)
    _, _, _, tp = _pair(cfg.dtype)
    mine = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, tree
    a, b = dict(flat(mine)), dict(flat(tp))
    assert a.keys() == b.keys()
    assert "/head/w" not in a                      # tied embeddings
    for key in a:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
    m = mine["layers"][0]["mixer"]
    for name in ("A_log", "D_skip", "dt_bias", "norm_scale"):
        torch.testing.assert_close(m[name], tp["layers"][0]["mixer"][name])
    w = m["w_in"].float()
    assert float(w.abs().max()) <= 3 / cfg.d_model ** 0.5 + 1e-3
    assert abs(float(m["conv_w"].float().std()) - 0.1) < 0.01
    assert float(m["conv_b"].abs().max()) == 0.0


def _requests(R, vocab):
    """The requests of tests/test_serving_cluster.py's engine test."""
    rng = np.random.default_rng(0)
    return [R(rid=i,
              prompt=rng.integers(1, vocab, size=rng.integers(4, 20))
              .astype(np.int32),
              max_new=int(rng.integers(4, 12)))
            for i in range(10)]


def test_engine_matches_jax_token_for_token():
    """The f32 smoke engine serves mamba2-130m as JAX does: the same
    tokens, placements and stats, and the same final caches, slots left by
    finished requests included (neither engine resets a slot's state)."""
    jc, tc, jp, tp = _pair("float32")
    kw = dict(num_replicas=2, b_slots=3, c_max=64, policy="bf")
    ref = JEngine(jc, jp, **kw)
    ref.submit(_requests(JRequest, jc.vocab_size))
    ref_done = ref.run(max_steps=600)
    eng = ServingEngine(tc, tp, audit=True, device="cpu", **kw)
    eng.submit(_requests(Request, tc.vocab_size))
    done = eng.run(max_steps=600)
    assert len(done) == 10
    assert [(r.rid, r.replica, r.slot, r.out) for r in done] == \
        [(r.rid, r.replica, r.slot, r.out) for r in ref_done]
    assert eng.stats == ref.stats
    assert max(eng.stats["queue_len"]) > 0
    np.testing.assert_array_equal(eng.admission.residual, RES)
    for rep, jrep in zip(eng.replicas, ref.replicas):
        mine = mamba_caches_to_numpy(rep.caches, tc)["p0"]
        theirs = jrep.caches["p0"]
        np.testing.assert_allclose(mine.conv, np.asarray(theirs.conv),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(mine.ssm, np.asarray(theirs.ssm),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(mine.length,
                                      np.asarray(theirs.length))
        assert (np.abs(mine.ssm).reshape(-1, *mine.ssm.shape[2:])
                .max(axis=(1, 2, 3)) > 0).all()   # every slot's state stale
