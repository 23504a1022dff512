"""Multi-resource BF-J/S engines of the port vs the JAX package on shared
streams.

Streams come from the JAX ``make_streams`` (or ``streams_from_trace``) and
reach the port through ``repro_torch.convert`` on the CPU.  Demands,
occupancies and the alignment score are integers on the RES grid, so every
field — occupancy included — must be equal, with no tolerance."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import synthesize_google_like_trace  # noqa: E402
from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro.core.engine import streams_from_trace as j_sft  # noqa: E402
from repro.core.engine.bfjs_mr import \
    run_bfjs_mr_streams as j_run  # noqa: E402
from repro.core.multi_resource import \
    alignment_scores as j_alignment_scores  # noqa: E402
from repro.kernels.bfjs_mr.bfjs_mr import bfjs_mr_pallas  # noqa: E402
from repro_torch.convert import (bfjs_mr_state_from_numpy,  # noqa: E402
                                 result_to_numpy, streams_from_numpy)
from repro_torch.core.engine import (Workload,  # noqa: E402
                                     alignment_score_pair,
                                     monte_carlo_policy, run_bfjs_mr_streams,
                                     run_policy_streams, streams_from_trace)
from repro_torch.core.multi_resource import alignment_scores  # noqa: E402
from repro_torch.core.quantize import RES  # noqa: E402
from repro_torch.kernels.bfjs_mr import bfjs_mr as bfjs_mr_kernel  # noqa: E402
from repro_torch.kernels.bfjs_mr.ops import bfjs_mr_simulate  # noqa: E402
from repro_torch.kernels.common import \
    GracefulDegradationWarning  # noqa: E402

FIELDS = ("queue_len", "occupancy", "departed", "dropped", "truncated",
          "preempted", "requeued", "lost")


def _sampler(lo, hi, R):
    if R == 1:
        return lambda key, n: jax.random.uniform(key, (n,), minval=lo,
                                                 maxval=hi)
    return lambda key, n: jax.random.uniform(key, (n, R), minval=lo,
                                             maxval=hi)


def _jax_streams(G, R, L, K, A_max, T, lam, mu, lo, hi, seed,
                 fault_rate=0.0):
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [j_make_streams(k, lam, mu, _sampler(lo, hi, R), L=L, K=K,
                           A_max=A_max, horizon=T, num_resources=R,
                           fault_rate=fault_rate, repair_rate=0.3)
            for k in keys]


def _to_port(sts):
    stack = [np.stack([np.asarray(getattr(s, f)) for s in sts])
             for f in ("n", "sizes", "durs")]
    up = None if sts[0].up is None else \
        np.stack([np.asarray(s.up) for s in sts])
    return streams_from_numpy(*stack, up=up, device="cpu")


def _assert_equal(port, refs, fields=FIELDS):
    """port: batched numpy PolicyResult; refs: per-member JAX results."""
    for g, ref in enumerate(refs):
        for f in fields:
            np.testing.assert_array_equal(getattr(port, f)[g],
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"member {g} field {f}")


# (R, capacity, L, K, Qcap, A_max, T, lam, mu, sizes, W, fault_rate, seed):
# the random-stream cases of tests/test_mr_engine.py (R = 2 and 3, and a
# capacity of (1, 0.75)), a starved work list and an undersized K (both
# truncate), queue overflow (drops), a fault plane, and the R = 1 lift
CASES = {
    "r2": (2, 1.0, 4, 8, 256, 5, 300, 0.35, 0.05, (0.05, 0.5), 24, 0.0, 1),
    "r3": (3, 1.0, 4, 8, 256, 5, 300, 0.25, 0.05, (0.05, 0.5), 24, 0.0, 2),
    "cap": (2, (1.0, 0.75), 4, 8, 256, 5, 300, 0.25, 0.05, (0.05, 0.45),
            24, 0.0, 4),
    "starved": (2, 1.0, 3, 16, 256, 6, 300, 1.2, 0.1, (0.05, 0.25), 1, 0.0,
                9),
    "small_k": (2, 1.0, 3, 2, 256, 6, 300, 1.2, 0.1, (0.05, 0.25), 32, 0.0,
                9),
    "overflow": (2, 1.0, 3, 4, 8, 6, 200, 4.0, 0.02, (0.05, 0.5), 3, 0.0,
                 3),
    "fault": (2, 1.0, 5, 8, 64, 5, 300, 0.6, 0.05, (0.05, 0.5), 24, 0.05,
              7),
    "r1_lift": (1, 1.0, 5, 6, 64, 6, 300, 0.5, 0.05, (0.05, 0.6), 24, 0.0,
                5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_engine_matches_jax(case):
    (R, cap, L, K, Qcap, A_max, T, lam, mu, sizes, W, fault_rate,
     seed) = CASES[case]
    sts = _jax_streams(2, R, L, K, A_max, T, lam, mu, *sizes, seed,
                       fault_rate=fault_rate)
    capacity = cap if isinstance(cap, tuple) else (cap,) * R
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=W,
              capacity=capacity)
    refs = [j_run(s, **kw) for s in sts]
    port = result_to_numpy(run_policy_streams(_to_port(sts),
                                              policy="bfjs-mr",
                                              engine="scan", **kw))
    _assert_equal(port, refs)
    assert port.occupancy.shape == (2, T, R)
    if case in ("starved", "small_k"):
        assert port.truncated.sum() > 0
    elif case == "overflow":
        assert port.dropped.sum() > 0
    else:
        assert port.truncated.sum() == 0 and port.dropped.sum() == 0
    if fault_rate:
        assert port.preempted.sum() > 0 and port.lost.sum() > 0
        np.testing.assert_array_equal(port.preempted,
                                      port.requeued + port.lost)
    assert port.departed[:, -1].min() > 0


@pytest.mark.parametrize("case", ["r3", "cap", "fault"])
def test_reference_engine_matches_jax_reference(case):
    """The port's host oracle == the JAX oracle on every field, and == the
    scan engine wherever nothing is truncated."""
    (R, cap, L, K, Qcap, A_max, T, lam, mu, sizes, W, fault_rate,
     seed) = CASES[case]
    st = _jax_streams(1, R, L, K, A_max, T, lam, mu, *sizes, seed,
                      fault_rate=fault_rate)[0]
    capacity = cap if isinstance(cap, tuple) else (cap,) * R
    ref = j_rps(st, policy="bfjs-mr", engine="reference", L=L,
                capacity=capacity)
    port_st = _to_port([st])
    got = result_to_numpy(run_policy_streams(port_st, policy="bfjs-mr",
                                             engine="reference", L=L,
                                             capacity=capacity))
    _assert_equal(got, [ref])
    scan = result_to_numpy(run_policy_streams(
        port_st, policy="bfjs-mr", engine="scan", L=L, K=K, Qcap=Qcap,
        A_max=A_max, work_steps=W, capacity=capacity))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(scan, f), getattr(got, f),
                                      err_msg=f)


# (R, L, K, Qcap, A_max, T, lam, mu, sizes, seed): R = 1 to 4, a stream
# whose queue builds up (BF-S refills from a deep queue), and a Qcap small
# enough to drop arrivals.  Every case keeps truncated == 0: the Pallas
# kernel pays the step bound, which the scan-engine comparison above covers.
PALLAS_CASES = {
    "r1": (1, 4, 8, 48, 5, 100, 0.5, 0.05, (0.05, 0.6), 5),
    "r2": (2, 4, 8, 48, 5, 100, 0.35, 0.05, (0.05, 0.5), 1),
    "r3": (3, 4, 8, 48, 5, 100, 0.3, 0.05, (0.05, 0.5), 2),
    "r4": (4, 5, 8, 48, 5, 100, 0.5, 0.05, (0.05, 0.4), 3),
    "queueing": (2, 3, 16, 64, 6, 120, 1.0, 0.03, (0.2, 0.7), 9),
    "drops": (2, 3, 16, 8, 6, 120, 3.0, 0.02, (0.1, 0.6), 3),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_version_matches_pallas(case):
    """The kernel wrapper on CPU tensors (its plain version) == the JAX
    Pallas kernel in interpret mode, on every field."""
    R, L, K, Qcap, A_max, T, lam, mu, sizes, seed = PALLAS_CASES[case]
    sts = _jax_streams(2, R, L, K, A_max, T, lam, mu, *sizes, seed)
    n, sz, durs = (np.stack([np.asarray(getattr(s, f)) for s in sts])
                   for f in ("n", "sizes", "durs"))
    if R == 1:
        sz = sz[..., None]
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=A_max + 8,
              capacity=(1.0,) * R)
    qlen, occ, ndep, dropped, trunc = bfjs_mr_pallas(n, sz, durs,
                                                     interpret=True, **kw)
    before = bfjs_mr_kernel.launches.count
    port = result_to_numpy(bfjs_mr_kernel.bfjs_mr_cuda(
        *(torch.from_numpy(np.asarray(x)) for x in (n, sz, durs)), **kw))
    assert bfjs_mr_kernel.launches.count == before  # CPU: plain version
    np.testing.assert_array_equal(port.queue_len, np.asarray(qlen))
    np.testing.assert_array_equal(port.occupancy, np.asarray(occ))
    np.testing.assert_array_equal(port.departed,
                                  np.cumsum(np.asarray(ndep), axis=1))
    np.testing.assert_array_equal(port.dropped, np.asarray(dropped))
    np.testing.assert_array_equal(port.truncated, np.asarray(trunc))
    assert port.truncated.sum() == 0
    assert port.departed[:, -1].min() > 0
    if case == "queueing":
        assert port.queue_len.mean() > 1
    if case == "drops":
        assert port.dropped.sum() > 0


def test_google_like_trace_uncollapsed_matches_jax():
    """The synthesized Google-like (cpu, mem) trace, uncollapsed: the
    port's streams_from_trace gives the JAX arrays, and the scan engine —
    and the kernel's plain version, on these trace-width durations — equal
    JAX's scan engine, untruncated."""
    trace = synthesize_google_like_trace(1200, 1200, seed=4)
    jst = j_sft(trace, collapse=False, horizon=2000)
    pst = streams_from_trace(trace, collapse=False, horizon=2000,
                             device="cpu")
    for f in ("n", "sizes", "durs"):
        np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    A = int(pst.sizes.shape[1])
    assert pst.sizes.shape == (2000, A, 2) and pst.durs.shape == (2000, A)
    kw = dict(L=24, K=24, Qcap=512, A_max=A, work_steps=48)
    ref = j_run(jst, capacity=(1.0, 1.0), **kw)
    assert int(ref.truncated) == 0 and int(ref.departed[-1]) > 0
    got = result_to_numpy(run_policy_streams(pst, policy="bfjs-mr",
                                             engine="scan", **kw))
    _assert_equal(type(got)(*(None if x is None else x[None]
                              for x in got)), [ref])
    batched = pst._replace(**{f: getattr(pst, f)[None]
                              for f in ("n", "sizes", "durs")})
    plain = result_to_numpy(bfjs_mr_simulate(batched, **kw))
    _assert_equal(plain, [ref], FIELDS[:5])


def test_scan_engine_resumes_from_jax_carry():
    """Slots 0..T/2 on JAX, the carry handed over, T/2..T on the port ==
    JAX straight through (departures restart per slice), fault plane on."""
    R, L, K, Qcap, A_max, T = 2, 5, 8, 64, 5, 240
    st = _jax_streams(1, R, L, K, A_max, T, 0.6, 0.05, 0.05, 0.5, 7,
                      fault_rate=0.05)[0]
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=24,
              capacity=(1.0, 1.0))
    full = j_run(st, **kw)
    h = T // 2
    first, carry = j_run(jax.tree.map(lambda x: x[:h], st),
                         return_state=True, **kw)
    rest = jax.tree.map(lambda x: x[h:], st)
    state = bfjs_mr_state_from_numpy([np.asarray(x) for x in carry],
                                     device="cpu")
    port = result_to_numpy(run_bfjs_mr_streams(
        streams_from_numpy(rest.n, rest.sizes, rest.durs, up=rest.up,
                           device="cpu"), state=state, **kw))
    np.testing.assert_array_equal(port.queue_len,
                                  np.asarray(full.queue_len)[h:])
    np.testing.assert_array_equal(port.occupancy,
                                  np.asarray(full.occupancy)[h:])
    np.testing.assert_array_equal(
        port.departed + np.asarray(first.departed)[-1],
        np.asarray(full.departed)[h:])
    for f in FIELDS[3:]:
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(full, f)))
    assert int(full.preempted) > int(first.preempted) > 0


def test_scan_engine_returns_the_jax_carry():
    R, L, K, Qcap, A_max, T = 3, 4, 6, 32, 4, 150
    st = _jax_streams(1, R, L, K, A_max, T, 0.8, 0.05, 0.05, 0.5, 3,
                      fault_rate=0.05)[0]
    kw = dict(L=L, K=K, Qcap=Qcap, A_max=A_max, capacity=(1.0,) * R)
    _, carry = j_run(st, return_state=True, **kw)
    _, state = run_bfjs_mr_streams(
        streams_from_numpy(st.n, st.sizes, st.durs, up=st.up, device="cpu"),
        return_state=True, **kw)
    assert len(state) == len(carry) == 18
    for name, x, y in zip(state._fields, state, carry):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=name)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_alignment_score_pair_is_exact(R):
    """(hi, lo) reassembles the exact integer score — the oracle's exact
    float64 alignment_scores (the port's copy and JAX's) — with lo in
    [0, 256), so the lexicographic argmin, ties included, is the oracle's
    argmin."""
    rng = np.random.default_rng(R)
    avail = rng.integers(0, RES + 1, size=(64, 40, R))
    avail[:, 20:] = avail[:, :20]          # every score appears twice
    avail[:, 5] = 0                        # and some are zero
    dem = rng.integers(1, RES + 1, size=(64, R))
    dem[0] = RES
    hi, lo = alignment_score_pair(torch.from_numpy(avail),
                                  torch.from_numpy(dem))
    hi, lo = hi.numpy().astype(np.int64), lo.numpy()
    assert ((0 <= lo) & (lo < 256)).all()
    for b in range(64):
        exact = (avail[b] * dem[b]).sum(axis=1)
        np.testing.assert_array_equal(hi[b] * 256 + lo[b], exact)
        oracle = alignment_scores(avail[b].astype(np.float64), dem[b])
        np.testing.assert_array_equal(
            oracle, j_alignment_scores(avail[b].astype(np.float64), dem[b]))
        np.testing.assert_array_equal(oracle, exact.astype(np.float64))
        lex = np.lexsort((np.arange(40), lo[b], hi[b]))[0]
        assert lex == int(np.argmin(oracle)) < 20


def test_cuda_engine_on_cpu_and_its_gate():
    """On CPU tensors engine="cuda" is the plain version (no launch); a
    fault plane moves loudly to the scan engine, or raises when strict; an
    R the kernel has no instance of raises either way."""
    def sampler(gen, n, device):
        return torch.rand(n, 2, generator=gen, device=device) * 0.45 + 0.05
    wl = Workload(lam=0.8, mu=0.05, sampler=sampler, num_resources=2)
    cfg = dict(L=4, K=8, Qcap=64, A_max=5, horizon=80, device="cpu")
    before = bfjs_mr_kernel.launches.count
    cuda = monte_carlo_policy(wl, seeds=[0, 1], policy="bfjs-mr",
                              engine="cuda", strict=True, **cfg)
    scan = monte_carlo_policy(wl, seeds=[0, 1], policy="bfjs-mr",
                              engine="scan", **cfg)
    assert bfjs_mr_kernel.launches.count == before
    for x, y in zip(result_to_numpy(cuda), result_to_numpy(scan)):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="fault-plane"):
        monte_carlo_policy(wl, seeds=[0], policy="bfjs-mr", engine="cuda",
                           strict=True, fault_rate=0.05, **cfg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = monte_carlo_policy(wl, seeds=[0], policy="bfjs-mr",
                                 engine="cuda", fault_rate=0.05, **cfg)
    assert any(issubclass(x.category, GracefulDegradationWarning)
               for x in w)
    assert res.occupancy.shape == (1, 80, 2)
    wide = Workload(lam=0.5, mu=0.05, num_resources=5,
                    sampler=lambda gen, n, device: torch.rand(
                        n, 5, generator=gen, device=device) * 0.2 + 0.05)
    for strict in (True, False):
        with pytest.raises(NotImplementedError, match="R <= 4"):
            monte_carlo_policy(wide, seeds=[0], policy="bfjs-mr",
                               engine="cuda", strict=strict, **cfg)
    one = monte_carlo_policy(wide, seeds=[0], policy="bfjs-mr",
                             engine="scan", **cfg)
    assert one.occupancy.shape == (1, 80, 5)
