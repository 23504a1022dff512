"""The port's event-driven engine (``repro_torch.core``) vs the JAX
package's (``repro.core``): data structures, job-size distributions,
schedulers and the simulator.

Both are host numpy fed the same numpy-seeded inputs and the same Philox
generator, so every comparison is exact: no tolerance anywhere."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import fenwick as j_fen, queues as j_q  # noqa: E402
from repro_torch.core import fenwick as p_fen, queues as p_q  # noqa: E402

RES = P.RES


# ---------------------------------------------------------------------------
# data structures under random operation sequences
# ---------------------------------------------------------------------------
def _job_tuple(job):
    if job is None:
        return None
    return (job.jid, job.size, job.eff_size, job.vq, job.arrival, job.dur)


@pytest.mark.parametrize("seed,size", [(0, 1024), (1, 1000), (2, 7),
                                       (3, RES + 1)])
def test_fenwick_matches_jax(seed, size):
    rng = np.random.default_rng(seed)
    a, b = j_fen.Fenwick(size), p_fen.Fenwick(size)
    counts = np.zeros(size, dtype=np.int64)
    for _ in range(300):
        key = int(rng.integers(0, size))
        delta = 1 if counts[key] == 0 or rng.random() < 0.6 else -1
        a.add(key, delta)
        b.add(key, delta)
        counts[key] += delta
        for probe in (int(rng.integers(-2, size + 2)), key, 0, size - 1):
            assert a.count_leq(probe) == b.count_leq(probe)
            assert a.max_leq(probe) == b.max_leq(probe)
            assert a.min_geq(probe) == b.min_geq(probe)
        if a.total:
            k = int(rng.integers(1, a.total + 1))
            assert a.kth(k) == b.kth(k)
        assert a.total == b.total
    np.testing.assert_array_equal(a.tree, b.tree)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 255), st.sampled_from([1, -1])),
                min_size=1, max_size=120))
def test_fenwick_descents_match_jax_and_naive(ops):
    a, b = j_fen.Fenwick(256), p_fen.Fenwick(256)
    counts = np.zeros(256, dtype=int)
    for key, delta in ops:
        if delta < 0 and counts[key] == 0:
            continue
        a.add(key, delta)
        b.add(key, delta)
        counts[key] += delta
        present = np.nonzero(counts)[0]
        for probe in (0, key, 127, 255):
            leq = present[present <= probe]
            assert b.max_leq(probe) == a.max_leq(probe) \
                == (leq[-1] if len(leq) else -1)
            geq = present[present >= probe]
            assert b.min_geq(probe) == a.min_geq(probe) \
                == (geq[0] if len(geq) else -1)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 17), (2, 64), (3, 1000)])
def test_segtree_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, RES + 1, n).astype(np.int64)
    a, b = j_fen.SegTreeMax(vals.copy()), p_fen.SegTreeMax(vals.copy())
    for _ in range(300):
        i, v = int(rng.integers(0, n)), int(rng.integers(0, RES + 1))
        a.update(i, v)
        b.update(i, v)
        probe = int(rng.integers(0, RES + 2))
        assert a.first_fit(probe) == b.first_fit(probe)
        assert a.get(i) == b.get(i) == v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_and_fifo_queues_match_jax(seed):
    rng = np.random.default_rng(seed)
    sa, sb = j_q.SortedJobQueue(), p_q.SortedJobQueue()
    fa, fb = j_q.FIFOJobQueue(), p_q.FIFOJobQueue()
    queued = {}                      # jid -> (jax job, port job)
    for i in range(400):
        op = rng.random()
        if op < 0.5:
            s = int(rng.choice([int(rng.integers(1, RES + 1)), 21845, 32768]))
            ja, jb = j_q.Job(i, s, s, -1, i, i % 5), p_q.Job(i, s, s, -1, i,
                                                               i % 5)
            sa.push(ja)
            sb.push(jb)
            fa.push(ja)
            fb.push(jb)
            queued[i] = (ja, jb)
        elif op < 0.8:
            cap = int(rng.integers(0, RES + 2))
            assert sa.peek_largest_leq(cap) == sb.peek_largest_leq(cap)
            ga, gb = sa.pop_largest_leq(cap), sb.pop_largest_leq(cap)
            assert _job_tuple(ga) == _job_tuple(gb)
            if ga is not None:
                del queued[ga.jid]
        elif op < 0.9 and queued:
            jid = int(rng.choice(sorted(queued)))
            ja, jb = queued.pop(jid)
            assert sa.remove(ja) is sb.remove(jb) is True
            assert sa.remove(ja) is sb.remove(jb) is False
        elif len(fa):
            assert _job_tuple(fa.head()) == _job_tuple(fb.head())
            assert _job_tuple(fa.pop()) == _job_tuple(fb.pop())
        assert len(sa) == len(sb) and len(fa) == len(fb)
        assert sa.total_size() == sb.total_size()
    assert _job_tuple(fa.head()) == _job_tuple(fb.head())


@pytest.mark.parametrize("seed,Jv", [(0, 2), (1, 3), (2, 5), (3, 8)])
def test_virtual_queues_match_jax(seed, Jv):
    rng = np.random.default_rng(seed)
    va, vb = j_q.VirtualQueues(Jv), p_q.VirtualQueues(Jv)
    queued = {}
    for i in range(400):
        op = rng.random()
        vq = int(rng.integers(0, 2 * Jv))
        if op < 0.45:
            s = int(rng.integers(1, RES + 1))
            assert va.classify(s) == vb.classify(s)
            q, eff = va.classify(s)
            ja, jb = j_q.Job(i, s, eff, q, i), p_q.Job(i, s, eff, q, i)
            va.push(ja)
            vb.push(jb)
            queued[i] = (ja, jb)
        elif op < 0.6:
            assert _job_tuple(va.head(vq)) == _job_tuple(vb.head(vq))
            got = va.pop_head(vq)
            assert _job_tuple(got) == _job_tuple(vb.pop_head(vq))
            if got is not None:
                del queued[got.jid]
        elif op < 0.75:
            cap = int(rng.integers(0, RES + 1))
            got = va.pop_largest_leq(vq, cap)
            assert _job_tuple(got) == _job_tuple(vb.pop_largest_leq(vq, cap))
            if got is not None:
                del queued[got.jid]
        elif op < 0.9:
            cap = int(rng.integers(0, RES + 1))
            got = va.pop_largest_leq_any(cap)
            assert _job_tuple(got) == _job_tuple(vb.pop_largest_leq_any(cap))
            if got is not None:
                del queued[got.jid]
        elif queued:
            ja, jb = queued.pop(int(rng.choice(sorted(queued))))
            assert va.remove_specific(ja) is vb.remove_specific(jb) is True
        np.testing.assert_array_equal(va.sizes, vb.sizes)
        assert len(va) == len(vb) == len(queued)


def test_cluster_queries_match_jax():
    """Placements, tightest-feasible and first-fit queries, departures and
    evictions on a heterogeneous cluster, step by step."""
    rng = np.random.default_rng(5)
    caps = np.array([RES, RES // 2, RES, RES // 4, 3 * RES // 4] * 2)
    a, b = J.Cluster(len(caps), caps.copy()), P.Cluster(len(caps),
                                                        caps.copy())
    placed = []
    for t in range(120):
        fa, ea = a.process_departures(t)
        fb, eb = b.process_departures(t)
        assert (fa, ea) == (fb, eb)
        for k in range(int(rng.integers(0, 6))):
            s = int(rng.integers(1, RES // 2))
            assert a.tightest_feasible(s) == b.tightest_feasible(s)
            assert a.first_fit(s) == b.first_fit(s)
            srv = a.tightest_feasible(s)
            if srv >= 0:
                jid = 1000 * t + k
                dep = t + int(rng.integers(1, 30))
                a.place(srv, J.Job(jid, s, s, -1, t), dep)
                b.place(srv, P.Job(jid, s, s, -1, t), dep)
                placed.append((srv, jid, dep))
        if placed and rng.random() < 0.1:
            srv, jid, dep = placed.pop(int(rng.integers(0, len(placed))))
            if dep > t and jid in a.jobs[srv]:
                assert _job_tuple(a.evict(srv, jid)) == \
                    _job_tuple(b.evict(srv, jid))
        a.accumulate_utilization()
        b.accumulate_utilization()
        np.testing.assert_array_equal(a.residual, b.residual)
        assert a.total_occupied() == b.total_occupied()
        assert (a.departed_jobs, a.departed_size) == \
            (b.departed_jobs, b.departed_size)
        a.check_invariants()
        b.check_invariants()
    assert a.busy_area == b.busy_area


# ---------------------------------------------------------------------------
# job-size distributions
# ---------------------------------------------------------------------------
_OBS = np.random.default_rng(11).uniform(0.0, 1.2, 300)


def _dists(mod):
    return {
        "uniform": mod.Uniform(0.1, 0.9),
        "uniform-point": mod.Uniform(0.4, 0.4),
        "discrete": mod.Discrete([0.7, 0.2, 0.5], [0.2, 0.5, 0.3]),
        "pareto": mod.TruncatedPareto(0.05, 1.3),
        "pareto-1": mod.TruncatedPareto(0.02, 1.0),
        "mixture": mod.Mixture([mod.Uniform(0.1, 0.3),
                                mod.Discrete([0.5, 0.8], [0.5, 0.5])],
                               [0.6, 0.4]),
        "empirical": mod.Empirical(_OBS),
    }


@pytest.mark.parametrize("name", sorted(_dists(J)))
def test_distributions_match_jax(name):
    a, b = _dists(J)[name], _dists(P)[name]
    for seed in (0, 1, 7):
        ra = np.random.Generator(np.random.Philox(seed))
        rb = np.random.Generator(np.random.Philox(seed))
        for n in (1, 5, 500):
            np.testing.assert_array_equal(a.sample(ra, n), b.sample(rb, n))
    xs = np.linspace(0.0, 1.0, 101)
    qs = np.linspace(0.0, 1.0, 33)
    np.testing.assert_array_equal(a.cdf(xs), b.cdf(xs))
    np.testing.assert_array_equal(a.quantile(qs), b.quantile(qs))
    assert np.asarray(a.cdf(0.35)).tolist() == np.asarray(b.cdf(0.35)).tolist()
    assert a.mean() == b.mean()
    assert a.min_size() == b.min_size()
    for x, y in zip(a.atoms(), b.atoms()):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# schedulers through simulate and simulate_trace
# ---------------------------------------------------------------------------
MW_TYPES = [0.25, 0.4, 0.6]


def _policy(mod, name, Jv=4):
    return {"bfjs": lambda: mod.BFJS(),
            "bfjs-stall": lambda: mod.BFJS(stall=True),
            "bfj": lambda: mod.BFJ(),
            "bfs": lambda: mod.BFS(),
            "fifo-ff": lambda: mod.FIFOFF(),
            "vqs": lambda: mod.VQS(J=Jv),
            "vqs-bf": lambda: mod.VQSBF(J=Jv),
            "maxweight": lambda: mod.MaxWeight(MW_TYPES)}[name]()


POLICIES = ["bfjs", "bfjs-stall", "bfj", "bfs", "fifo-ff", "vqs", "vqs-bf",
            "maxweight"]


def assert_same_result(a, b):
    """Every SimResult field equal, floats bit for bit."""
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, (f, x, y)


# (L, lam, dist, service (kind, mean), horizon, seed, capacities); the
# small clusters of tests/test_schedulers.py, L <= 12
SIM_CASES = {
    "L1-uniform": (1, 0.3, ("uniform", 0.35, 0.65), ("geometric", 20.0),
                   400, 0, None),
    "L3-uniform": (3, 0.1, ("uniform", 0.1, 0.9), ("geometric", 50.0),
                   1500, 42, None),
    "L4-fixed": (4, 0.5, ("uniform", 0.05, 0.35), ("fixed", 20.0),
                 600, 3, None),
    "L12-uniform": (12, 0.4, ("uniform", 0.1, 0.9), ("geometric", 25.0),
                    800, 9, None),
    "L2-discrete": (2, 0.06, ("discrete",), ("geometric", 30.0), 1500, 5,
                    None),
    "L3-discrete-fixed": (3, 0.1, ("discrete",), ("fixed", 25.0), 1000, 8,
                          None),
    "L3-hetero": (3, 0.1, ("uniform", 0.05, 0.45), ("geometric", 25.0),
                  1000, 0, "hetero"),
    "L5-pareto": (5, 0.3, ("pareto",), ("geometric", 30.0), 500, 4, None),
}


def _sim_dist(mod, spec):
    if spec[0] == "uniform":
        return mod.Uniform(spec[1], spec[2])
    if spec[0] == "discrete":
        return mod.Discrete(MW_TYPES, [0.3, 0.4, 0.3])
    return mod.TruncatedPareto(0.05, 1.2)


# MaxWeight needs the finite type set of a Discrete law
SIM_PAIRS = [(p, c) for p in POLICIES for c in sorted(SIM_CASES)
             if p != "maxweight" or SIM_CASES[c][2][0] == "discrete"]


@pytest.mark.parametrize("policy,case", SIM_PAIRS)
def test_simulate_matches_jax(policy, case):
    L, lam, dspec, (kind, mean), H, seed, caps = SIM_CASES[case]
    if caps == "hetero":
        caps = np.array([RES, RES // 2, RES // 4], dtype=np.int64)
    res = [mod.simulate(_policy(mod, policy), L=L, lam=lam,
                        dist=_sim_dist(mod, dspec),
                        service=mod.ServiceModel(kind, mean), horizon=H,
                        seed=seed, capacities=caps, record_every=3,
                        check_invariants=True)
           for mod in (J, P)]
    assert res[0].departed > 0
    assert_same_result(*res)


def _random_trace(seed, T, N, grid=64):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, T, N)          # unsorted: the stable argsort
    sizes = rng.integers(1, grid, N) / float(grid)
    durs = rng.integers(0, 60, N)          # 0 is clamped to 1 slot
    return slots, sizes, durs


# MaxWeight's configurations assume unit servers
TRACE_CASES = [(p, *c) for p in POLICIES
               for c in [(0, 5, None), (7, 12, None), (3, 1, None),
                         (4, 3, "hetero")]
               if p != "maxweight" or c[2] is None]


@pytest.mark.parametrize("policy,seed,L,caps", TRACE_CASES)
def test_simulate_trace_matches_jax(policy, seed, L, caps):
    T, N = 300, 40 * L
    slots, sizes, durs = _random_trace(seed, T, N)
    if policy == "maxweight":
        sizes = np.asarray(MW_TYPES)[np.random.default_rng(seed).integers(
            0, len(MW_TYPES), N)]
    if caps == "hetero":
        caps = np.array([RES, RES // 2, RES // 4], dtype=np.int64)
    for rec in (1, 7):
        res = [mod.simulate_trace(_policy(mod, policy), L=L,
                                  arrival_slots=slots, sizes=sizes,
                                  durations=durs, horizon=T, seed=seed,
                                  capacities=caps, record_every=rec)
               for mod in (J, P)]
        assert res[0].arrived == N
        assert_same_result(*res)
    # horizon=None replays to the last arrival
    res = [mod.simulate_trace(_policy(mod, policy), L=L,
                              arrival_slots=slots, sizes=sizes,
                              durations=durs, capacities=caps)
           for mod in (J, P)]
    assert_same_result(*res)


def test_stall_differs_from_bfjs():
    """BF-J/S's stall is a different policy, not a no-op: with small jobs
    holding servers under half full while 0.8 jobs wait, its queue
    differs, in both packages alike."""
    rng = np.random.default_rng(2)
    slots = rng.integers(0, 300, 200)
    sizes = np.where(rng.random(200) < 0.5, 0.1, 0.8)
    durs = rng.integers(1, 60, 200)
    out = {}
    for stall in (False, True):
        res = [mod.simulate_trace(mod.BFJS(stall=stall), L=4,
                                  arrival_slots=slots, sizes=sizes,
                                  durations=durs, horizon=300,
                                  record_every=1) for mod in (J, P)]
        assert_same_result(*res)
        out[stall] = res[1].queue_lens
    assert not np.array_equal(out[False], out[True])


# ---------------------------------------------------------------------------
# tests/test_schedulers.py's claims, through the port
# ---------------------------------------------------------------------------
@settings(max_examples=6, deadline=None, derandomize=True)
@given(st.integers(0, 10_000), st.integers(1, 4),
       st.floats(0.05, 0.9), st.floats(0.1, 0.95))
def test_invariants_random_workloads_match_jax(seed, L, lam, lo_frac):
    lo = 0.05 + 0.6 * lo_frac
    for policy in POLICIES[:-1]:
        res = [mod.simulate(_policy(mod, policy), L=L, lam=lam,
                            dist=mod.Uniform(lo, min(lo + 0.3, 1.0)),
                            service=mod.ServiceModel("geometric", 20.0),
                            horizon=300, seed=seed, check_invariants=True)
               for mod in (J, P)]
        assert_same_result(*res)
        r = res[1]
        assert r.arrived - r.departed - r.final_queue >= 0
        assert 0.0 <= r.utilization <= 1.0


def test_fifo_head_of_line_blocking_matches_jax():
    """FIFO-FF cannot reorder past a 0.9 job at the head; BF-J/S can."""
    out = {}
    for name in ("fifo-ff", "bfjs"):
        res = [mod.simulate(_policy(mod, name), L=2, lam=0.028,
                            dist=mod.Discrete([0.1, 0.9], [0.5, 0.5]),
                            service=mod.ServiceModel("geometric", 100.0),
                            horizon=30_000, seed=1) for mod in (J, P)]
        assert_same_result(*res)
        out[name] = res[1]
    assert out["bfjs"].mean_queue_tail < out["fifo-ff"].mean_queue_tail


def test_bfjs_packs_exact_fit_matches_jax():
    """0.4 + 0.6 share one server under Best-Fit (rho = 1.5 < rho* = 2)."""
    res = [mod.simulate(mod.BFJS(), L=1, lam=0.03,
                        dist=mod.Discrete([0.4, 0.6], [0.5, 0.5]),
                        service=mod.ServiceModel("geometric", 50.0),
                        horizon=20_000, seed=3, check_invariants=True)
           for mod in (J, P)]
    assert_same_result(*res)
    assert res[1].final_queue < 50
    assert res[1].departed > 0.95 * (res[1].arrived - 50)
