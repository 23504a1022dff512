"""The port's LM stack (configs, layers, attention, blocks, model, convert)
on the CPU against the JAX package, at smoke sizes.

Parameters come from the JAX ``init_params`` through
``convert.model_params_from_numpy``; tokens and embeds from a numpy seed.
Tolerances: float32 within 1e-4 (abs and rel; the two frameworks sum in
other orders); bfloat16 within 2e-2 of the logits' max abs value (the
frameworks round some elementwise ops, e.g. SiLU, at other points)."""
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
from repro_torch.convert import (kv_caches_from_numpy,  # noqa: E402
                                 kv_caches_to_numpy, model_params_from_numpy)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

DECODE_ARCHS = [a for a in ARCH_IDS if get_config(a).sliding_window == 0]


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


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
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
    ref, _ = JM.forward(jp, jc, **jin)
    got, aux = M.forward(tp, tc, **tin)
    assert got.shape == (2, 48, tc.vocab_size) and got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == 0.0
    _close(got, ref, dtype)
    _close(M.prefill(tp, tc, **tin), JM.prefill(jp, jc, **jin), dtype)


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
    cache = kv_caches_from_numpy(jax.tree.map(np.asarray, jcache), tc, "cpu")
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
    mine = kv_caches_to_numpy(cache, tc)
    for name in ("k", "v"):
        ref = getattr(jnp_cache["p0"], name)
        tol = 1e-4 if dtype == "float32" else 2e-2 * np.abs(ref).max()
        np.testing.assert_allclose(getattr(mine["p0"], name), ref, atol=tol,
                                   rtol=1e-4 if dtype == "float32" else 0)
    np.testing.assert_array_equal(mine["p0"].length,
                                  np.asarray(jnp_cache["p0"].length))
    back = kv_caches_to_numpy(kv_caches_from_numpy(mine, tc, "cpu"), tc)
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
    mine = kv_caches_to_numpy(cache, tc)
    for b in range(3):
        ref = np.asarray(jcaches[b]["p0"].k)[:, 0]
        np.testing.assert_allclose(mine["p0"].k[:, b], ref, atol=1e-4,
                                   rtol=1e-4)
    assert list(mine["p0"].length) == [C] * tc.num_layers


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full forward logits (the mirror
    of tests/test_models.py::test_decode_matches_forward)."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
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


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-72b"])
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
    assert float(w.abs().max()) <= 3 / cfg.d_model ** 0.5 + 1e-3
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.987) < 0.05


def test_unported_layers_and_archs_raise():
    from repro_torch.configs.registry import get_config as port_get_config
    for arch, item in (("dbrx-132b", "11e"),
                       ("deepseek-v2-lite-16b", "11d"),
                       ("jamba-1.5-large-398b", "11e")):
        with pytest.raises(NotImplementedError, match=item):
            port_get_config(arch)
        cfg = ModelConfig(**dataclasses.asdict(j_smoke(arch)))
        with pytest.raises(NotImplementedError, match=item):
            M.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="item 11"):
            M.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("llama3-9b")
    cfg = get_smoke_config("h2o-danube-3-4b")
    params = M.init_params(cfg, 0, device="cpu")
    caches = M.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="item 11c"):
        M.decode_step(params, cfg, torch.zeros(1, 1, dtype=torch.int64), 0,
                      caches)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    for call in (lambda: M.init_params(cfg, 0),
                 lambda: M.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
