"""The port's AdamW and schedules (``repro_torch.train.optimizer``) against
the JAX package's on the same numpy inputs.

Tolerance: 1e-6 relative.  Both compute in float32 with JAX's operation
order; sums over a tensor (the global norm) and transcendental functions
(cos, pow) are each framework's own, a few float32 ulps apart."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import \
    constant_schedule as j_constant  # noqa: E402
from repro.train.optimizer import cosine_schedule as j_cosine  # noqa: E402
from repro_torch.train.optimizer import (AdamW, AdamWState,  # noqa: E402
                                         constant_schedule, cosine_schedule)

RTOL = 1e-6


@pytest.mark.parametrize("peak,warmup,total,min_ratio", [
    (3e-4, 10, 50, 0.1), (1e-3, 0, 7, 0.0), (6e-4, 20, 20, 0.25)])
def test_schedules_equal_jax(peak, warmup, total, min_ratio):
    steps = np.arange(total + 6, dtype=np.int32)
    j = j_cosine(peak, warmup, total, min_ratio)
    t = cosine_schedule(peak, warmup, total, min_ratio)
    got = np.array([float(t(torch.tensor(s))) for s in steps])
    ref = np.array([float(j(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    assert t(torch.tensor(3)).dtype == torch.float32
    c = constant_schedule(peak)(torch.tensor(4))
    assert c.dtype == torch.float32
    assert float(c) == float(j_constant(peak)(jnp.asarray(4)))


def _tree(seed):
    """A matrix, a vector and a leaf the gradient does not reach."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32),
         "unused": {"e": rng.standard_normal((4, 3)).astype(np.float32)}}
    return p


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal(5) * scale).astype(np.float32)}


def _run(moment_dtype, clip_norm, scale, steps=5):
    sched = (3e-2, 2, 8)
    jopt = JAdamW(schedule=j_cosine(*sched), clip_norm=clip_norm,
                  moment_dtype=moment_dtype)
    topt = AdamW(schedule=cosine_schedule(*sched), clip_norm=clip_norm,
                 moment_dtype=moment_dtype)
    p0 = _tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"w": torch.from_numpy(p0["w"].copy()),
          "b": torch.from_numpy(p0["b"].copy()),
          "unused": {"e": torch.from_numpy(p0["unused"]["e"].copy())}}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _grads(10 + i, scale)
        jg = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"]),
              "unused": {"e": jnp.zeros((4, 3), jnp.float32)}}
        tg = {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"]),
              "unused": {"e": None}}
        jp, js, jm = jopt.update(jg, js, jp)
        tp, ts, tm = topt.update(tg, ts, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    return jp, js, tp, ts


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("scale,clip", [(0.01, 1.0), (10.0, 1.0),
                                        (10.0, 0.0)])
def test_adamw_updates_equal_jax(scale, clip):
    """Five updates; scale 10 with clip 1 clips every step, scale 0.01
    never does, clip 0 turns it off.  The leaf without a gradient decays
    (a matrix) as under JAX's zero cotangent."""
    jp, js, tp, ts = _run("", clip, scale)
    assert int(ts.step) == int(js.step) == 5
    for k in ("w", "b"):
        _close(tp[k], jp[k])
        _close(ts.mu[k], js.mu[k])
        _close(ts.nu[k], js.nu[k])
    _close(tp["unused"]["e"], jp["unused"]["e"])
    assert not np.array_equal(tp["unused"]["e"].numpy(),
                              _tree(0)["unused"]["e"])


def test_adamw_bf16_moments_equal_jax():
    """The port of tests/test_infra.py:103: bf16 moments halve the state,
    track the float32 run, and equal JAX's bf16 run (moments bit for bit
    after rounding, parameters within 1e-6)."""
    jp, js, tp, ts = _run("bfloat16", 1.0, 0.01)
    assert ts.mu["w"].dtype == torch.bfloat16 == ts.nu["b"].dtype
    assert ts.mu["w"].element_size() == 2
    for k in ("w", "b"):
        _close(tp[k], jp[k])
        np.testing.assert_array_equal(
            ts.mu[k].float().numpy(), np.asarray(js.mu[k], np.float32))
    _, _, tf, _ = _run("", 1.0, 0.01)
    np.testing.assert_allclose(tp["w"].numpy(), tf["w"].numpy(), rtol=2e-2)


def test_adamw_constant_ones_like_jax_infra_test():
    """tests/test_infra.py:103's exact case: ones (32, 32), gradient 0.01,
    constant lr 1e-2, five steps, bf16 against float32 moments."""
    params = {"w": torch.ones((32, 32))}
    grads = {"w": torch.full((32, 32), 0.01)}
    full = AdamW(schedule=constant_schedule(1e-2))
    half = AdamW(schedule=constant_schedule(1e-2), moment_dtype="bfloat16")
    pf = {"w": params["w"].clone()}
    ph = {"w": params["w"].clone()}
    sf, sh = full.init(pf), half.init(ph)
    assert isinstance(sh, AdamWState) and sh.mu["w"].dtype == torch.bfloat16
    for _ in range(5):
        pf, sf, _ = full.update(grads, sf, pf)
        ph, sh, _ = half.update(grads, sh, ph)
    np.testing.assert_allclose(pf["w"].numpy(), ph["w"].numpy(), rtol=2e-2)
