"""The port's partition helpers, stability theory and MaxWeight oracle vs
the JAX package's, and the paper's Section VII examples through the port.

Both sides are host numpy in float64 with the same order of operations,
so the configurations, rho values and simulations are compared exactly;
the paper's claims are then asserted on the port's own results, as
tests/test_stability.py and tests/test_paper_examples.py assert them on
JAX's."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import stability as j_stab  # noqa: E402
from repro_torch.core import stability as p_stab  # noqa: E402

RES = P.RES


def assert_same_result(a, b):
    """Every SimResult field equal, floats bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, (f.name, x, y)


# ---------------------------------------------------------------------------
# partition helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Jv", range(2, 11))
def test_k_red_helpers_match_jax(Jv):
    assert P.k_red_is_feasible(Jv) is J.k_red_is_feasible(Jv) is True
    np.testing.assert_array_equal(P.k_red(Jv), J.k_red(Jv))
    rng = np.random.default_rng(Jv)
    for q in [np.zeros(2 * Jv, dtype=np.int64),
              np.ones(2 * Jv, dtype=np.int64),      # ties: the lowest row
              *rng.integers(0, 10_000, (20, 2 * Jv))]:
        i, conf = P.max_weight_config(Jv, q)
        ji, jconf = J.max_weight_config(Jv, q)
        assert i == ji
        np.testing.assert_array_equal(conf, jconf)
        w = P.k_red(Jv) @ q
        assert w[i] == w.max()


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(min_value=1, max_value=RES), st.integers(2, 10))
def test_partition_types_match_jax(size, Jv):
    a, b = J.PartitionI(Jv), P.PartitionI(Jv)
    assert a.type_of_scalar(size) == b.type_of_scalar(size)
    sizes = np.array([size, max(size // 3, 1), RES], dtype=np.int64)
    np.testing.assert_array_equal(a.type_of(sizes), b.type_of(sizes))
    np.testing.assert_array_equal(a.effective_size(sizes),
                                  b.effective_size(sizes))
    for j in range(2 * Jv):
        assert a.upper_bound_int(j) == b.upper_bound_int(j)


# ---------------------------------------------------------------------------
# configurations and rho* (the cases of tests/test_stability.py)
# ---------------------------------------------------------------------------
def test_enumerate_and_maximal_configs_match_jax():
    sizes = np.array([32768, 21845], dtype=np.int64)   # 0.5, 1/3
    confs = P.enumerate_configs(sizes)
    np.testing.assert_array_equal(confs, J.enumerate_configs(sizes))
    feasible = {(k1, k2) for k1 in range(3) for k2 in range(4)
                if k1 * 32768 + k2 * 21845 <= 65536}
    assert set(map(tuple, confs)) == feasible
    maxi = P.maximal_configs(confs, sizes)
    np.testing.assert_array_equal(maxi, J.maximal_configs(confs, sizes))
    assert set(map(tuple, maxi)) == {(2, 0), (1, 1), (0, 3)}
    # more types, a smaller capacity, and the explosion guard
    sizes = P.to_grid([0.15, 0.22, 0.31, 0.45])
    for cap in (RES, RES // 2):
        a = P.enumerate_configs(sizes, cap)
        np.testing.assert_array_equal(a, J.enumerate_configs(sizes, cap))
        np.testing.assert_array_equal(P.maximal_configs(a, sizes, cap),
                                      J.maximal_configs(a, sizes, cap))
    with pytest.raises(RuntimeError, match="exceeds 10"):
        P.enumerate_configs(sizes, RES, max_configs=10)


# (sizes, probs, L) of tests/test_stability.py: Fig. 3a, Fig. 3b,
# Proposition 2 (true and upper-rounded), the scaling in servers
RHO_CASES = {
    "fig3a": ([0.4, 0.6], [0.5, 0.5], 1, 2.0),
    "fig3b": ([0.2, 0.5], [2 / 3, 1 / 3], 1, 10 / 3),
    "prop2-true": ([0.49, 0.51], [0.5, 0.5], 1, 2.0),
    "prop2-rounded": ([0.5, 0.51], [0.5, 0.5], 1, 4 / 3),
    "scaling-L1": ([0.3, 0.5], [0.5, 0.5], 1, None),
    "scaling-L4": ([0.3, 0.5], [0.5, 0.5], 4, None),
    "three-types": ([0.15, 0.35, 0.7], [0.5, 0.3, 0.2], 3, None),
}


@pytest.mark.parametrize("case", sorted(RHO_CASES))
def test_rho_star_discrete_matches_jax(case):
    sizes, probs, L, expect = RHO_CASES[case]
    r = P.rho_star_discrete(np.array(sizes), np.array(probs), L=L)
    assert r == J.rho_star_discrete(np.array(sizes), np.array(probs), L=L)
    if expect is not None:
        assert r == pytest.approx(expect, rel=1e-4)
    grid = P.to_grid(sizes)        # grid ints take the same path
    assert P.rho_star_discrete(grid, np.array(probs), L=L) == r


def test_scaling_and_proposition2_through_the_port():
    r1 = P.rho_star_discrete(np.array([0.3, 0.5]), np.array([0.5, 0.5]), L=1)
    r4 = P.rho_star_discrete(np.array([0.3, 0.5]), np.array([0.5, 0.5]), L=4)
    assert r4 == pytest.approx(4 * r1, rel=1e-6)
    true, rounded = (P.rho_star_discrete(np.array(RHO_CASES[k][0]),
                                         np.array([0.5, 0.5]))
                     for k in ("prop2-true", "prop2-rounded"))
    assert rounded == pytest.approx(2 / 3 * true, rel=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_simplex_matches_jax(seed):
    """The dense Bland's-rule simplex on random feasible LPs: the value and
    the solution bit for bit."""
    rng = np.random.default_rng(seed)
    m, n = rng.integers(2, 7), rng.integers(2, 9)
    A = rng.uniform(-1.0, 2.0, (m, n))
    b = rng.uniform(0.0, 3.0, m)
    A[0] = np.abs(A[0]) + 0.1                  # bounded
    c = rng.uniform(0.0, 1.0, n)
    va, xa = j_stab._simplex(c, A, b)
    vb, xb = p_stab._simplex(c, A, b)
    assert va == vb
    np.testing.assert_array_equal(xa, xb)


def _dists(mod):
    return {"uniform-0.1-0.9": mod.Uniform(0.1, 0.9),
            "uniform-0.2-0.9": mod.Uniform(0.2, 0.9),
            "pareto": mod.TruncatedPareto(0.2, 1.5),
            "discrete": mod.Discrete([0.3, 0.6], [0.5, 0.5])}


@pytest.mark.parametrize("name", sorted(_dists(J)))
def test_theorem1_bounds_match_jax(name):
    a, b = _dists(J)[name], _dists(P)[name]
    assert P.rho_star_upper_bound(b, 5) == J.rho_star_upper_bound(a, 5)
    for n in (0, 1, 2):
        qa, qb = j_stab.quantile_partition(a, n), p_stab.quantile_partition(
            b, n)
        np.testing.assert_array_equal(qa, qb)
        for rounding in ("upper", "lower"):
            for x, y in zip(j_stab.rounded_types(a, qa, rounding),
                            p_stab.rounded_types(b, qb, rounding)):
                np.testing.assert_array_equal(x, y)
        assert P.rho_bounds(b, n, L=2) == J.rho_bounds(a, n, L=2)
    with pytest.raises(ValueError):
        p_stab.rounded_types(b, qb, "nearest")


def test_lemma1_and_theorem1_through_the_port():
    """tests/test_stability.py's Lemma 1 and Theorem 1 claims on the
    port's numbers."""
    assert P.rho_star_upper_bound(P.Uniform(0.1, 0.9), 5) \
        == pytest.approx(5 / 0.5)
    ups, los = zip(*(P.rho_bounds(P.Uniform(0.2, 0.9), n, L=1)
                     for n in (0, 1, 2)))
    assert list(ups) == sorted(ups)
    assert list(los) == sorted(los, reverse=True)
    assert ups[-1] <= los[-1]
    assert los[-1] - ups[-1] < los[0] - ups[0]


@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.lists(st.floats(0.15, 1.0), min_size=1, max_size=4, unique=True),
       st.integers(1, 4))
def test_rho_star_random_matches_jax_and_bounds(sizes, L):
    """L <= rho* <= L / mean(R) for any discrete law, equal to JAX's."""
    sizes = np.asarray(sizes)
    probs = np.full(len(sizes), 1.0 / len(sizes))
    r = P.rho_star_discrete(sizes, probs, L=L)
    assert r == J.rho_star_discrete(sizes, probs, L=L)
    assert r >= L - 1e-6
    assert r <= L / float(np.dot(sizes, probs)) + 1e-4 + L * 1e-3


# ---------------------------------------------------------------------------
# MaxWeight
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("types", [[0.4, 0.6], [0.2, 0.5], [0.25, 0.4, 0.6],
                                   [13107, 26214, 45875]])
def test_maxweight_configs_match_jax(types):
    a, b = J.MaxWeight(types), P.MaxWeight(types)
    np.testing.assert_array_equal(a.type_sizes, b.type_sizes)
    np.testing.assert_array_equal(a.configs, b.configs)
    assert a.J == b.J and a.name == b.name == "maxweight"


def test_maxweight_rejects_undeclared_sizes():
    pol = P.MaxWeight([0.4, 0.6])
    with pytest.raises(ValueError, match="not one of the declared types"):
        pol.make_job(0, P.to_grid([0.5])[0], 0)


def test_maxweight_oracle_stable_on_finite_types():
    """tests/test_schedulers.py's oracle claim: rho = 1.8 < rho* = 2."""
    res = [mod.simulate(mod.MaxWeight([0.4, 0.6]), L=1, lam=0.018,
                        dist=mod.Discrete([0.4, 0.6], [0.5, 0.5]),
                        service=mod.ServiceModel("geometric", 100.0),
                        horizon=40_000, seed=2, check_invariants=True)
           for mod in (J, P)]
    assert_same_result(*res)
    assert res[1].final_queue < 120


# ---------------------------------------------------------------------------
# the paper's Section VII examples (tests/test_paper_examples.py; Fig. 3b,
# the longest, has tests/test_torch_paper_fig3b.py)
# ---------------------------------------------------------------------------
H = 150_000


def _both(make, **kw):
    """simulate through JAX and the port; equal on every field."""
    res = [mod.simulate(make(mod), dist=kw["dist"](mod),
                        service=kw["service"](mod),
                        **{k: v for k, v in kw.items()
                           if k not in ("dist", "service")})
           for mod in (J, P)]
    assert_same_result(*res)
    return res[1]


@pytest.fixture(scope="module")
def fig3a_results():
    kw = dict(L=1, lam=0.014, horizon=H, seed=11,
              dist=lambda m: m.Discrete([0.4, 0.6], [0.5, 0.5]),
              service=lambda m: m.ServiceModel("geometric", 100.0))
    return {"bf-js": _both(lambda m: m.BFJS(), **kw),
            "vqs": _both(lambda m: m.VQS(J=2), **kw),
            "vqs-bf": _both(lambda m: m.VQSBF(J=2), **kw)}


def test_fig3a_vqs_unstable_bf_stable(fig3a_results):
    """Fig 3a: rate 0.014 > (2/3)*0.02 => VQS diverges; BF-J/S and VQS-BF
    support it (rho = 1.4 < 2 = rho*)."""
    r = fig3a_results
    assert r["vqs"].mean_queue_tail > 5 * r["bf-js"].mean_queue_tail
    assert r["vqs"].mean_queue_tail > 5 * r["vqs-bf"].mean_queue_tail
    assert r["bf-js"].final_queue < 40
    assert r["vqs-bf"].final_queue < 40
    q = r["vqs"].queue_lens
    assert q[-len(q) // 4:].mean() > 1.5 * q[: len(q) // 4].mean()


def test_bfjs_meets_half_guarantee_uniform():
    """Theorem 2 sanity: BF-J/S stable at rho = 0.9 * (rho*/2) for
    U[0.1, 0.9] on L = 3."""
    res = _both(lambda m: m.BFJS(), L=3, lam=2.7 / 50.0, horizon=60_000,
                seed=13, dist=lambda m: m.Uniform(0.1, 0.9),
                service=lambda m: m.ServiceModel("geometric", 50.0))
    assert res.final_queue < 60
    assert res.mean_queue_tail < 60


def test_vqsbf_beats_vqs_delay_uniform():
    """Section VII.A.3: VQS has clearly worse delay than VQS-BF on
    U[0.1, 0.9] at high traffic (alpha = 0.88, L = 5)."""
    kw = dict(L=5, lam=0.88 * 5 / 0.5 / 100.0, horizon=60_000, seed=3,
              dist=lambda m: m.Uniform(0.1, 0.9),
              service=lambda m: m.ServiceModel("geometric", 100.0))
    vqs = _both(lambda m: m.VQS(J=4), **kw)
    vqsbf = _both(lambda m: m.VQSBF(J=4), **kw)
    assert vqsbf.mean_queue_tail < vqs.mean_queue_tail
