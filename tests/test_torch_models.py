"""The port's LM stack (configs, layers, attention, blocks, model, convert)
on the CPU against the JAX package, at smoke sizes.

Parameters come from the JAX ``init_params`` through
``convert.model_params_from_numpy``; tokens and embeds from a numpy seed.
Tolerances: float32 within 1e-4 (abs and rel; the two frameworks sum in
other orders); bfloat16 within 2e-2 of the logits' max abs value (the
frameworks round some elementwise ops, e.g. SiLU, at other points).  In
bfloat16 an MoE router's near tie can pick another expert in either
framework (JAX's own bf16 run is up to 0.93 of max from its float32 run
at such a token), so there the positions are held one by one and 10% may
differ (``_close(..., routed=...)``); Jamba's positions, which also carry
eight layers of bf16 Mamba and MoE rounding, are held at 6e-2 (JAX's own
bf16 run is up to 0.062 of max from its float32 run away from a
flip)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import (caches_from_numpy,  # noqa: E402
                                 caches_to_numpy, model_params_from_numpy)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

DECODE_ARCHS = ARCH_IDS
NEW_ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b", "jamba-1.5-large-398b"]


def _pair(arch, dtype="float32", **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = j_smoke(arch).with_(dtype=dtype, **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _inputs(cfg, B, S, seed):
    """(JAX kwargs, port kwargs) of the same tokens or embeds."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}


def _routed(cfg):
    """The per-position bf16 limit of an MoE stack (``_close``), else
    None."""
    if not cfg.num_experts:
        return None
    return 6e-2 if cfg.attn_every != 1 else 2e-2


def _close(got, ref, dtype, routed=None):
    """``routed``: an MoE model's per-position limit in bf16, where each
    position (a row of the last axis) is held within ``routed`` of the
    max and at most 10% may be off by a near-tie routing pick."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    elif routed:
        err = np.abs(got - ref).reshape(-1, ref.shape[-1]).max(-1)
        assert (err > routed * np.abs(ref).max()).mean() <= 0.1
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_rope_and_rms_norm_match_jax():
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 5)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), atol=2e-4, rtol=1e-4)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                    1e-5).numpy(),
        np.asarray(JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                               1e-5)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(j_smoke(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_prefill_match_jax(arch, dtype):
    jc, tc, jp, tp = _pair(arch, dtype)
    jin, tin = _inputs(tc, 2, 48, 1)
    ref, jaux = JM.forward(jp, jc, **jin)
    got, aux = M.forward(tp, tc, **tin)
    assert got.shape == (2, 48, tc.vocab_size) and got.dtype == torch.float32
    routed = _routed(tc)
    assert float(aux["moe_aux_loss"]) == pytest.approx(
        float(jaux["moe_aux_loss"]), rel=1e-4 if dtype == "float32" else 2e-3)
    assert (float(aux["moe_aux_loss"]) > 0) == (routed is not None)
    _close(got, ref, dtype, routed)
    last = M.prefill(tp, tc, **tin)
    _close(last, JM.prefill(jp, jc, **jin), dtype, routed)
    torch.testing.assert_close(last, got[:, -1], atol=1e-5, rtol=1e-5)


def test_qkv_bias_forward_matches_jax():
    """Non-zero q/k/v biases (the JAX init leaves them at zero)."""
    jc = j_smoke("qwen2-72b").with_(dtype="float32")
    tc = ModelConfig(**dataclasses.asdict(jc))
    tree = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    mixer = tree["layers"]["p0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        mixer[name] = rng.standard_normal(mixer[name].shape).astype(
            np.float32) * 0.5
    jp = jax.tree.map(jnp.asarray, tree)
    jin, tin = _inputs(tc, 2, 32, 3)
    ref, _ = JM.forward(jp, jc, **jin)
    got, _ = M.forward(model_params_from_numpy(tree, tc, "cpu"), tc, **tin)
    _close(got, ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_forward_matches_jax(dtype):
    """h2o-danube's smoke window (32) over 96 tokens: the flash path's
    window mask, whole-tile skips included."""
    jc, tc, jp, tp = _pair("h2o-danube-3-4b", dtype)
    assert tc.sliding_window == 32
    jin, tin = _inputs(tc, 1, 96, 4)
    _close(M.forward(tp, tc, **tin)[0], JM.forward(jp, jc, **jin)[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decode_matches_jax(dtype):
    """16 decode steps from a JAX-made cache: logits and every layer's k/v
    cache (converted to the JAX layout) stay within tolerance."""
    jc, tc, jp, tp = _pair("llama3-8b", dtype)
    B, C = 2, 16
    jin, tin = _inputs(tc, B, C, 5)
    toks = np.array(jin["tokens"])
    jcache = JM.init_cache(jc, B, C)
    cache = caches_from_numpy(jax.tree.map(np.asarray, jcache), tc, "cpu")
    assert cache[0].k.shape == (B, tc.num_kv_heads, C, tc.resolved_head_dim)
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    for i in range(C):
        ref, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(i, jnp.int32), jcache)
        got, cache = M.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                   torch.full((B,), i, dtype=torch.int32),
                                   cache)
        _close(got, ref, dtype)
    jnp_cache = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    mine = caches_to_numpy(cache, tc)
    for name in ("k", "v"):
        ref = getattr(jnp_cache["p0"], name)
        tol = 1e-4 if dtype == "float32" else 2e-2 * np.abs(ref).max()
        np.testing.assert_allclose(getattr(mine["p0"], name), ref, atol=tol,
                                   rtol=1e-4 if dtype == "float32" else 0)
    np.testing.assert_array_equal(mine["p0"].length,
                                  np.asarray(jnp_cache["p0"].length))
    back = caches_to_numpy(caches_from_numpy(mine, tc, "cpu"), tc)
    for a, b in zip(back["p0"], mine["p0"]):
        np.testing.assert_array_equal(a, b)


def test_ragged_decode_matches_jax_per_row():
    """Rows at different positions in one batched step equal the JAX
    single-row decode of each (the serving engine's vmap), caches
    included."""
    jc, tc, jp, tp = _pair("llama3-8b")
    C = 12
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tc.vocab_size, (3, C)).astype(np.int32)
    lag = [0, 2, 5]
    cache = M.init_cache(tc, 3, C, "cpu")
    jcaches = [JM.init_cache(jc, 1, C) for _ in range(3)]
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    for i in range(C):
        pos = np.array([max(i - g, 0) for g in lag], np.int32)
        tok = toks[np.arange(3), pos][:, None]
        got, cache = M.decode_step(tp, tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos), cache)
        for b in range(3):
            ref, jcaches[b] = step(jp, jnp.asarray(tok[b:b + 1]),
                                   jnp.asarray(pos[b]), jcaches[b])
            _close(got[b:b + 1], ref, "float32")
    mine = caches_to_numpy(cache, tc)
    for b in range(3):
        ref = np.asarray(jcaches[b]["p0"].k)[:, 0]
        np.testing.assert_allclose(mine["p0"].k[:, b], ref, atol=1e-4,
                                   rtol=1e-4)
    assert list(mine["p0"].length) == [C] * tc.num_layers


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward logits (the mirror
    of tests/test_models.py::test_decode_matches_forward, whose capacity
    factor keeps a batched prefill's MoE from dropping what decode
    keeps)."""
    cfg = get_smoke_config(arch).with_(dtype="float32", capacity_factor=16.0)
    params = M.init_params(cfg, 0, device="cpu")
    _, tin = _inputs(cfg, 1, 16, 7)
    full, _ = M.forward(params, cfg, **tin)
    caches = M.init_cache(cfg, 1, 16, "cpu")
    outs = []
    for i in range(16):
        x = {k: v[:, i:i + 1] for k, v in tin.items()}
        logits, caches = M.decode_step(params, cfg, next(iter(x.values())),
                                       i, caches)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-72b",
                                  "deepseek-v2-lite-16b", "dbrx-132b"])
def test_init_params_has_the_jax_structure(arch):
    """Port init gives the converted JAX tree's structure, shapes and
    dtypes (matrices in cfg.dtype, norm scales float32) and the JAX laws."""
    cfg = get_smoke_config(arch)
    _, tc, _, tp = _pair(arch, cfg.dtype)
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
    for key in a:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
        assert a[key].dtype == (torch.float32 if key.endswith("scale")
                                else torch.bfloat16)
    w = mine["layers"][0]["ffn"]["w_gate"].float()
    fan_in = w.shape[0]                     # E for an expert stack, as in JAX
    assert float(w.abs().max()) <= 3 / fan_in ** 0.5 + 1e-3
    assert abs(float(w.std()) * fan_in ** 0.5 - 0.987) < 0.05


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("llama3-9b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("deepseek-v3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_decode_resumes_jax_caches(arch, dtype):
    """MLA, MoE and the Jamba mix of Mamba, attention and MoE: JAX decodes
    8 steps, the port resumes from JAX's caches (``caches_from_numpy``)
    for 8 more beside it, logits within tolerance; the port's caches
    (``caches_to_numpy``) equal JAX's and round-trip, and JAX resumes from
    them for one more step."""
    jc, tc, jp, tp = _pair(arch, dtype)
    B, C = 1, 24
    toks = np.array(_inputs(tc, B, 17, 9)[0]["tokens"])
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    jcache = JM.init_cache(jc, B, C)
    for i in range(8):
        _, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32), jcache)
    cache = caches_from_numpy(jax.tree.map(np.asarray, jcache), tc, "cpu")
    kinds = {type(c).__name__ for c in cache}
    assert kinds == {"deepseek-v2-lite-16b": {"MLACache"},
                     "dbrx-132b": {"KVCache"},
                     "jamba-1.5-large-398b": {"KVCache", "MambaCache"}}[arch]
    refs, gots = [], []
    for i in range(8, 16):
        ref, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(i, jnp.int32), jcache)
        got, cache = M.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                   i, cache)
        refs.append(np.asarray(ref, np.float32))
        gots.append(got.float().numpy())
    _close(np.stack(gots), np.stack(refs), dtype, _routed(tc))
    mine = caches_to_numpy(cache, tc)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    assert mine.keys() == ref.keys()
    for p in mine:
        for a, b in zip(mine[p][:2], ref[p][:2]):
            assert a.shape == b.shape
            _close(a, b, dtype, _routed(tc))
        np.testing.assert_array_equal(mine[p].length, ref[p].length)
    back = caches_to_numpy(caches_from_numpy(mine, tc, "cpu"), tc)
    for p in mine:
        for a, b in zip(back[p], mine[p]):
            np.testing.assert_array_equal(a, b)
    # and back: JAX takes one more step from the port's caches
    leaves = [jnp.asarray(a, b.dtype) for a, b in zip(
        jax.tree.leaves(mine), jax.tree.leaves(jcache))]
    jmine = jax.tree.unflatten(jax.tree.structure(jcache), leaves)
    tok = toks[:, 16:17]
    ref, _ = step(jp, jnp.asarray(tok), jnp.asarray(16, jnp.int32), jmine)
    got, _ = M.decode_step(tp, tc, torch.from_numpy(tok), 16, cache)
    if dtype == "float32":
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_decode_matches_jax_past_the_window(dtype):
    """h2o-danube's smoke window (32) over 80 decode steps at two rows'
    positions: the ring of 32 slots wraps twice; logits within tolerance
    at every step and the ring equal to JAX's (JAX's per-row decode is its
    engine's vmap, so each row is one ``decode_step`` there)."""
    jc, tc, jp, tp = _pair("h2o-danube-3-4b", dtype)
    T, lag = 80, [0, 7]
    toks = np.array(_inputs(tc, 2, T, 10)[0]["tokens"])
    cache = M.init_cache(tc, 2, 96, "cpu")
    assert cache[0].k.shape[2] == tc.sliding_window == 32
    jcaches = [JM.init_cache(jc, 1, 96) for _ in lag]
    step = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    for i in range(T):
        pos = np.array([max(i - g, 0) for g in lag], np.int32)
        tok = toks[np.arange(2), pos][:, None]
        got, cache = M.decode_step(tp, tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos), cache)
        for b in range(2):
            ref, jcaches[b] = step(jp, jnp.asarray(tok[b:b + 1]),
                                   jnp.asarray(pos[b]), jcaches[b])
            _close(got[b:b + 1], ref, dtype)
    mine = caches_to_numpy(cache, tc)["p0"]
    for b in range(2):
        ref = np.asarray(jcaches[b]["p0"].k, np.float32)[:, 0]
        tol = 1e-4 if dtype == "float32" else 2e-2 * np.abs(ref).max()
        assert np.abs(mine.k[:, b] - ref).max() <= tol


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    for call in (lambda: M.init_params(cfg, 0),
                 lambda: M.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
