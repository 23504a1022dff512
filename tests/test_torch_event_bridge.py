"""The oracle bridge of the port: its accelerated VQS and VQS-BF engines
replay a trace exactly as its event-driven engine does.

``run_policy_streams(streams_from_trace(...), policy="vqs"|"vqs-bf")`` on
the ``"scan"`` and ``"cuda"`` engines must equal the port's
``simulate_trace(VQS(J))`` / ``simulate_trace(VQSBF(J))`` queue trajectory
slot for slot, with nothing truncated or dropped (the seeds and shapes of
tests/test_vqs_engine.py and tests/test_vqs_bf_engine.py).  On CPU
tensors the ``"cuda"`` engine runs the kernels' plain versions; the card
holds the kernels to the same oracle at full width in ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro_torch.core import VQS, VQSBF, simulate_trace  # noqa: E402
from repro_torch.core.engine import (run_policy_streams,  # noqa: E402
                                     streams_from_trace)

# vqs-bf serves one placement per work step, so the bound is sized to the
# per-slot burst (tests/test_vqs_bf_engine.py's WORK)
WORK = 64

POLICIES = {"vqs": (VQS, {}), "vqs-bf": (VQSBF, {"work_steps": WORK})}


def _random_trace(seed, T, N, grid=64):
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.integers(0, T, N))
    sizes = rng.integers(1, grid, N) / float(grid)
    durs = rng.integers(1, 60, N)
    return slots, sizes, durs


@pytest.mark.parametrize("engine", ["scan", "cuda"])
@pytest.mark.parametrize("seed,J,L", [(0, 3, 5), (7, 5, 12), (3, 2, 1)])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_engine_equals_event_driven_oracle_on_trace(policy, engine, seed,
                                                    J, L):
    T, N = 400, 60 * L
    slots, sizes, durs = _random_trace(seed, T, N)
    sched, extra = POLICIES[policy]
    ref = simulate_trace(sched(J=J), L=L, arrival_slots=slots, sizes=sizes,
                         durations=durs, horizon=T, seed=0, record_every=1)
    st = streams_from_trace(slots, sizes, durs, horizon=T, device="cpu")
    res = run_policy_streams(st, policy=policy, engine=engine, J=J, L=L,
                             K=1 << J, Qcap=2048,
                             A_max=int(st.sizes.shape[1]), **extra)
    assert int(res.truncated) == 0
    assert int(res.dropped) == 0
    np.testing.assert_array_equal(res.queue_len.numpy(), ref.queue_lens)
    assert int(res.departed[-1]) == ref.departed
    assert ref.arrived == N


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_event_driven_oracle_equals_jax_on_trace(policy):
    """The oracle the engines are held to is JAX's, field for field."""
    T, N = 400, 60 * 5
    slots, sizes, durs = _random_trace(0, T, N)
    kw = dict(L=5, arrival_slots=slots, sizes=sizes, durations=durs,
              horizon=T, seed=0, record_every=1)
    got = simulate_trace(POLICIES[policy][0](J=3), **kw)
    jsched = {"vqs": jcore.VQS, "vqs-bf": jcore.VQSBF}[policy]
    want = jcore.simulate_trace(jsched(J=3), **kw)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
