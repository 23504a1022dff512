"""The port's three stream-driven oracles against the JAX package's.

* bfjs: ``_run_bfjs_reference_streams`` on the streams of the JAX
  ``make_streams(key, ...)`` equals JAX's ``run_bfjs(key, ...,
  engine="reference")``, which draws the same numbers in-loop from the key;
* vqs, vqs-bf: ``_run_vqs_reference_streams`` and
  ``_run_vqs_bf_reference_streams`` equal the JAX functions of the same
  names on the same streams.

Streams reach the port through ``repro_torch.convert`` on the CPU, two
members each, so the member-by-member path is covered too.  Every
``PolicyResult`` field is equal; bfjs's occupancy, which JAX sums in
another order, agrees to rtol=1e-6 (tests/test_torch_bfjs.py's bar).
Each case runs at a calm and a queueing load, and once on a fault plane.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_bfjs as j_run_bfjs  # noqa: E402
from repro.core.engine.vqs import \
    _run_vqs_reference_streams as j_vqs_ref  # noqa: E402
from repro.core.engine.vqs_bf import \
    _run_vqs_bf_reference_streams as j_vqs_bf_ref  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core.engine.bfjs import \
    _run_bfjs_reference_streams  # noqa: E402
from repro_torch.core.engine.vqs import \
    _run_vqs_reference_streams  # noqa: E402
from repro_torch.core.engine.vqs_bf import \
    _run_vqs_bf_reference_streams  # noqa: E402

G = 2
EXACT = ("queue_len", "departed", "dropped", "truncated", "preempted",
         "requeued", "lost")


def _uniform(lo, hi):
    def sampler(key, n):
        return jax.random.uniform(key, (n,), minval=lo, maxval=hi)
    return sampler


#: One sampler object per law: the JAX functions take it as a static
#: argument, so a fresh closure would compile them again.
WIDE, BIG = _uniform(0.05, 0.9), _uniform(0.55, 0.95)
#: One geometry for every policy, so the JAX stream and oracle programs
#: compile as few times as the cases allow.
GEO = dict(L=4, K=16, Qcap=64, A_max=5, horizon=100)
VQS3, VQS4 = dict(GEO, J=3), dict(GEO, J=4)

#: name -> (policy, config, lam, mu, sampler, fault_rate).  Offered loads
#: (lam E[size] / (mu L)) 0.4 (calm) and 1.4 (queueing); VQS takes K >=
#: 2**J, the packing bound, except in the K-overflow cases.
CASES = {
    # sizes above one half: one job a server, so a slot where two servers
    # free with two jobs waiting refills both, from duration lanes 0 and 1
    "bfjs-refills": ("bfjs", dict(GEO, K=2), 3.0, 0.5, BIG, 0.0),
}
for _p, _cfg in (("bfjs", GEO), ("vqs", VQS3), ("vqs-bf", VQS3)):
    CASES.update({
        f"{_p}-calm": (_p, _cfg, 0.17, 0.05, WIDE, 0.0),
        f"{_p}-queueing": (_p, _cfg, 0.6, 0.05, WIDE, 0.0),
        f"{_p}-faulted": (_p, _cfg, 0.6, 0.05, WIDE, 0.05),
    })
for _p in ("vqs", "vqs-bf"):
    CASES.update({
        f"{_p}-queueing-J4": (_p, VQS4, 0.6, 0.05, WIDE, 0.0),
        f"{_p}-K-overflow": (_p, dict(VQS3, K=2), 0.6, 0.05, WIDE, 0.0),
    })

PORT = {"bfjs": _run_bfjs_reference_streams,
        "vqs": _run_vqs_reference_streams,
        "vqs-bf": _run_vqs_bf_reference_streams}


@pytest.fixture(scope="module")
def jax_runs():
    """(port streams, per-member JAX results) for each case, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            policy, cfg, lam, mu, sampler, fr = CASES[name]
            keys = jax.random.split(jax.random.PRNGKey(11), G)
            geo = {k: cfg[k] for k in ("L", "K", "A_max", "horizon")}
            sts = [j_make_streams(k, lam, mu, sampler, **geo,
                                  fault_rate=fr, repair_rate=0.3)
                   for k in keys]
            eng = {k: v for k, v in cfg.items() if k != "horizon"}
            if policy == "bfjs":
                refs = [j_run_bfjs(k, lam, mu, sampler, **cfg,
                                   engine="reference", fault_rate=fr,
                                   repair_rate=0.3) for k in keys]
            else:
                fn = j_vqs_ref if policy == "vqs" else j_vqs_bf_ref
                refs = [fn(st, **eng) for st in sts]
            stack = [np.stack([np.asarray(getattr(s, f)) for s in sts])
                     for f in ("n", "sizes", "durs")]
            up = None if fr == 0.0 else np.stack([np.asarray(s.up)
                                                  for s in sts])
            cache[name] = (streams_from_numpy(*stack, up=up, device="cpu"),
                           refs, eng)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_engine_equals_jax_oracle(name, jax_runs):
    policy = CASES[name][0]
    streams, refs, eng = jax_runs(name)
    got = result_to_numpy(PORT[policy](streams, **eng))
    assert got.queue_len.shape == (G, CASES[name][1]["horizon"])
    for g, ref in enumerate(refs):
        for f in EXACT:
            np.testing.assert_array_equal(getattr(got, f)[g],
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"member {g} field {f}")
        if policy == "bfjs":
            np.testing.assert_allclose(got.occupancy[g],
                                       np.asarray(ref.occupancy), rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.occupancy[g],
                                          np.asarray(ref.occupancy))

    # what each case is there to exercise actually happens
    q = got.queue_len.astype(np.int64)
    if "calm" in name:
        assert q.mean() < 1.0 and got.departed[:, -1].min() > 0
    if "queueing" in name:
        assert q.mean() > 1.0
    if "faulted" in name:
        assert got.preempted.min() > 0 and got.requeued.min() > 0
    if "overflow" in name:
        assert got.truncated.min() > 0
    if name == "bfjs-refills":
        n = streams.n.numpy().astype(np.int64)
        ndep = np.diff(got.departed, axis=1, prepend=0)
        waiting = np.concatenate([np.zeros((G, 1), np.int64), q[:, :-1]],
                                 axis=1) + n
        assert ((ndep >= 2) & (waiting >= 2)).sum() > 10


@pytest.mark.parametrize("policy", ["vqs", "vqs-bf"])
def test_reference_engine_equals_event_driven_oracle_on_trace(policy):
    """On trace streams the VQS-family oracles replay the port's
    event-driven ``simulate_trace`` (tests/test_torch_event_bridge.py holds
    the scan and cuda engines to it the same way)."""
    from repro_torch.core import VQS, VQSBF, simulate_trace
    from repro_torch.core.engine import run_policy_streams, \
        streams_from_trace
    rng = np.random.default_rng(5)
    T, N, L, J = 160, 200, 4, 3
    slots = np.sort(rng.integers(0, T, N))
    sizes = rng.integers(1, 64, N) / 64.0
    durs = rng.integers(1, 40, N)
    ref = simulate_trace((VQS if policy == "vqs" else VQSBF)(J=J), L=L,
                         arrival_slots=slots, sizes=sizes, durations=durs,
                         horizon=T, seed=0, record_every=1)
    st = streams_from_trace(slots, sizes, durs, horizon=T, device="cpu")
    res = run_policy_streams(st, policy=policy, engine="reference", J=J,
                             L=L, K=1 << J, Qcap=2048,
                             A_max=int(st.sizes.shape[1]))
    assert int(res.truncated) == 0 and int(res.dropped) == 0
    assert ref.queue_lens.mean() > 1.0
    np.testing.assert_array_equal(res.queue_len.numpy(), ref.queue_lens)
    assert int(res.departed[-1]) == ref.departed
