"""The multi-resource trace bridge of the port (``simulate_mr``,
``simulate_mr_trace``, ``MRResult`` and the ``CollapsedMaxBFJS`` baseline
in ``repro_torch.core.multi_resource``) against the JAX package's
``repro.core.multi_resource``: every ``MRResult`` field equal, ``extras``
included; and the port's ``bfjs-mr`` engines equal to the bridge on the
same trace."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import multi_resource as jm  # noqa: E402
from repro.core.trace import load_trace_csv as j_load  # noqa: E402
from repro.core.trace import \
    synthesize_google_like_trace as j_synth  # noqa: E402
from repro_torch.core import load_trace_csv, \
    synthesize_google_like_trace  # noqa: E402
from repro_torch.core import multi_resource as pm  # noqa: E402
from repro_torch.core.engine import (run_policy_streams,  # noqa: E402
                                     streams_from_trace)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")


def anti_correlated(rng, n):
    """cpu-heavy or mem-heavy jobs (tests/test_extensions.py's law)."""
    heavy = rng.uniform(0.45, 0.55, size=n)
    light = rng.uniform(0.05, 0.1, size=n)
    flip = rng.uniform(size=n) < 0.5
    return np.stack([np.where(flip, heavy, light),
                     np.where(flip, light, heavy)], axis=1)


def uniform3(rng, n):
    return rng.uniform(0.05, 0.6, size=(n, 3))


def _equal_results(port, ref):
    assert type(port).__name__ == type(ref).__name__ == "MRResult"
    for f in ("queue_lens", "arrived", "departed", "mean_queue",
              "mean_queue_tail", "final_queue", "utilization"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert port.extras.keys() == ref.extras.keys()
    for k in ref.extras:
        np.testing.assert_array_equal(port.extras[k], ref.extras[k],
                                      err_msg=k)
        assert port.extras[k].dtype == ref.extras[k].dtype


@pytest.mark.parametrize("policy,L,R,sampler,lam,svc,H,every", [
    ("MultiResourceBFJS", 8, 2, anti_correlated, 0.5, 20.0, 800, 10),
    ("CollapsedMaxBFJS", 4, 2, anti_correlated, 0.3, 25.0, 800, 10),
    ("MultiResourceBFJS", 4, 3, uniform3, 0.4, 10.0, 600, 1),
    ("CollapsedMaxBFJS", 4, 3, uniform3, 0.4, 10.0, 600, 7),
])
def test_simulate_mr_equals_jax(policy, L, R, sampler, lam, svc, H, every):
    pol_p, pol_j = getattr(pm, policy)(L, R), getattr(jm, policy)(L, R)
    port = pm.simulate_mr(pol_p, lam, sampler, svc, H, seed=3,
                          record_every=every)
    ref = jm.simulate_mr(pol_j, lam, sampler, svc, H, seed=3,
                         record_every=every)
    _equal_results(port, ref)
    assert ref.departed > 0 and ref.mean_queue > 0
    np.testing.assert_array_equal(pol_p.occupied, pol_j.occupied)


def _trace(kind):
    if kind == "fixture":
        return load_trace_csv(FIXTURE, slot_seconds=10.0), \
            j_load(FIXTURE, slot_seconds=10.0)
    return synthesize_google_like_trace(900, 900, seed=4), \
        j_synth(900, 900, seed=4)


@pytest.mark.parametrize("policy,L,kind,horizon,every", [
    ("MultiResourceBFJS", 16, "synth", 1200, 1),
    ("CollapsedMaxBFJS", 16, "synth", 1200, 5),
    ("MultiResourceBFJS", 4, "fixture", None, 1),
    ("CollapsedMaxBFJS", 4, "fixture", 300, 1),
])
def test_simulate_mr_trace_equals_jax(policy, L, kind, horizon, every):
    tp, tj = _trace(kind)
    port = pm.simulate_mr_trace(
        getattr(pm, policy)(L, 2), tp.arrival_slots,
        np.stack([tp.cpu, tp.mem], axis=1), tp.durations, horizon=horizon,
        record_every=every)
    ref = jm.simulate_mr_trace(
        getattr(jm, policy)(L, 2), tj.arrival_slots,
        np.stack([tj.cpu, tj.mem], axis=1), tj.durations, horizon=horizon,
        record_every=every)
    _equal_results(port, ref)
    assert ref.departed > 0


def test_simulate_mr_trace_rejects_a_demand_plane_of_another_width():
    for mod in (pm, jm):
        with pytest.raises(ValueError, match=r"demands must be \(N, R=3\)"):
            mod.simulate_mr_trace(mod.MultiResourceBFJS(4, 3), [0, 1],
                                  np.full((2, 2), 0.5), [3, 3])


@pytest.mark.parametrize("engine", ["reference", "scan", "cuda"])
def test_bfjs_mr_engines_equal_the_bridge(engine):
    """Oracle, bridge and engines tell one story on the uncollapsed
    synthesized trace: the streams oracle and simulate_mr_trace share one
    quantization (multi_resource.grid_demands)."""
    trace = synthesize_google_like_trace(900, 900, seed=4)
    st = streams_from_trace(trace, collapse=False, horizon=1200,
                            device="cpu")
    res = run_policy_streams(st, policy="bfjs-mr", engine=engine, L=16,
                             K=24, Qcap=512, work_steps=48)
    bridge = pm.simulate_mr_trace(
        pm.MultiResourceBFJS(16, 2), trace.arrival_slots,
        np.stack([trace.cpu, trace.mem], axis=1), trace.durations,
        horizon=1200)
    assert int(res.truncated) == 0 and int(res.dropped) == 0
    assert bridge.mean_queue > 0
    np.testing.assert_array_equal(res.queue_len.numpy(), bridge.queue_lens)
    np.testing.assert_array_equal(
        res.occupancy.numpy(), bridge.extras["occupancy"].astype(np.float32))
    np.testing.assert_array_equal(res.departed.numpy(),
                                  bridge.extras["departed_cum"])
