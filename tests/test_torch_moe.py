"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
JAX package's ``moe_apply`` and, for decode, its vmapped serving step
(``make_ragged_decode``), at smoke sizes.

Parameters come from the JAX ``moe_init`` / ``init_params``; inputs from a
numpy seed.  float32 within 1e-4 decides; bfloat16 within 2e-2 of max."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.serving.engine import make_ragged_decode  # noqa: E402
from repro_torch.convert import (caches_to_numpy,  # noqa: E402
                                 model_params_from_numpy)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

MOE_ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b", "jamba-1.5-large-398b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layer(arch, dtype, **kw):
    """(JAX config, port config, JAX moe params, port moe params)."""
    jc = j_smoke(arch).with_(dtype=dtype, **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JMoE.moe_init(jax.random.PRNGKey(3), jc)
    tree = jax.tree.map(np.asarray, jp)

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else
                torch.from_numpy(np.asarray(v, np.float32).copy()).to(
                    DTYPES[dtype][1]) for k, v in node.items()}
    return jc, tc, jp, conv(tree)


def _x(cfg, B, S, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
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
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax_where_it_drops(arch, dtype):
    """Outputs, the Switch loss, the drop rate and the routing picks at a T
    whose capacity drops tokens (capacity factor 0.5)."""
    jc, tc, jp, tp = _layer(arch, dtype, capacity_factor=0.5)
    jx, tx = _x(tc, 2, 24, 1, dtype)
    ref, jaux = JMoE.moe_apply(jp, jx, jc)
    got, aux = TMoE.moe_apply(tp, tx, tc)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, ref, dtype)
    drop = float(aux["moe_drop_rate"])
    assert drop > 0.1
    assert drop == pytest.approx(float(jaux["moe_drop_rate"]), abs=1e-6)
    assert float(aux["moe_aux_loss"]) == pytest.approx(
        float(jaux["moe_aux_loss"]), rel=1e-4 if dtype == "float32" else 2e-3)
    # the picks: JAX's router (its moe_apply's first lines) on the same x
    probs = jax.nn.softmax((jx.reshape(-1, jc.d_model)
                            @ jp["router"].astype(jx.dtype)).astype(
        jnp.float32), axis=-1)
    j_w, j_e = jax.lax.top_k(probs, jc.num_experts_per_tok)
    _, t_w, t_e = TMoE.route(tp, tx.reshape(1, -1, tc.d_model), tc)
    t_e, j_e, probs = t_e[0].numpy(), np.asarray(j_e), np.asarray(probs)
    if dtype == "float32":
        np.testing.assert_array_equal(t_e, j_e)
        np.testing.assert_allclose(
            t_w[0].numpy(), np.asarray(j_w / j_w.sum(-1, keepdims=True)),
            atol=1e-6, rtol=1e-5)
    else:
        # bf16 router logits round differently in the two frameworks'
        # products, so a near tie may pick the other expert: at most a few
        # picks differ, each between experts JAX scores within 1%
        t, j = np.nonzero(t_e != j_e)
        assert len(t) <= 0.05 * t_e.size
        gap = np.abs(probs[t, t_e[t, j]] - probs[t, j_e[t, j]])
        assert (gap <= 1e-2 * probs[t, j_e[t, j]]).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_without_drops_matches_jax(arch):
    """The default capacity factor, and the shared experts."""
    jc, tc, jp, tp = _layer(arch, "float32")
    jx, tx = _x(tc, 3, 7, 2, "float32")
    ref, jaux = JMoE.moe_apply(jp, jx, jc)
    got, aux = TMoE.moe_apply(tp, tx, tc)
    _close(got, ref, "float32")
    assert float(aux["moe_drop_rate"]) == pytest.approx(
        float(jaux["moe_drop_rate"]), abs=1e-6)
    assert ("shared" in tp) == (tc.num_shared_experts > 0)


def test_per_row_routing_is_each_row_alone():
    """``per_row`` equals routing each row in a call of its own; taken over
    the batch, the capacity drops pairs that a row alone keeps."""
    jc, tc, jp, tp = _layer("deepseek-v2-lite-16b", "float32")
    _, tx = _x(tc, 8, 1, 2, "float32")
    got, aux = TMoE.moe_apply(tp, tx, tc, per_row=True)
    rows = torch.cat([TMoE.moe_apply(tp, tx[b:b + 1], tc)[0]
                      for b in range(8)])
    torch.testing.assert_close(got, rows, atol=1e-4, rtol=1e-4)
    assert float(aux["moe_drop_rate"]) == 0.0
    _, batch_aux = TMoE.moe_apply(tp, tx, tc)
    assert float(batch_aux["moe_drop_rate"]) > 0.0


def _ragged_inputs(cfg, B, steps, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (steps, B)).astype(np.int32)
    start = rng.integers(0, 6, B).astype(np.int32)
    return toks, start


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batched_decode_equals_jax_vmapped_decode(arch):
    """8 rows at ragged positions through the port's one batched
    ``decode_step`` equal JAX's ``make_ragged_decode`` (``vmap`` over the
    rows, each routed with T = 1) in tokens and caches, and each row's
    logits equal JAX's single-row ``decode_step``.  Routing the 8 rows
    together (capacity 3 for the smoke deepseek's 8 experts, top-2) would
    drop pairs that JAX keeps."""
    jc = j_smoke(arch).with_(dtype="float32")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    B, C, steps = 8, 16, 6
    toks, start = _ragged_inputs(tc, B, steps, 7)
    ragged = make_ragged_decode(jc)
    jcaches = JM.init_cache(jc, B, C)
    single = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    rows = [JM.init_cache(jc, 1, C) for _ in range(B)]
    caches = M.init_cache(tc, B, C, "cpu")
    for i in range(steps):
        pos = start + i
        j_tok, jcaches = ragged(jp, jnp.asarray(toks[i]), jnp.asarray(pos),
                                jcaches)
        logits, caches = M.decode_step(
            tp, tc, torch.from_numpy(toks[i][:, None]),
            torch.from_numpy(pos), caches)
        np.testing.assert_array_equal(
            logits[:, 0].argmax(-1).numpy(), np.asarray(j_tok))
        for b in range(B):
            ref, rows[b] = single(jp, jnp.asarray(toks[i][b:b + 1, None]),
                                  jnp.asarray(pos[b]), rows[b])
            _close(logits[b:b + 1], ref, "float32")
    mine = caches_to_numpy(caches, tc)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jcaches)
    for p in mine:
        for got, want in zip(mine[p][:2], ref[p][:2]):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(mine[p].length, ref[p].length)
