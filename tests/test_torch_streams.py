"""Port foundation vs the JAX package: streams, workload, ops, convert."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import ops as jops  # noqa: E402
from repro.core.engine import streams as jstreams  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core.engine import (INF_SLOT, PolicyResult,  # noqa: E402
                                     SchedStreams, Workload, best_fit_place,
                                     best_fit_server, fault_plane_from_events,
                                     first_empty_positions,
                                     largest_fitting_job, make_fault_plane,
                                     make_streams, resolve_work_steps,
                                     row_sum_lr, with_fault_plane)


def uniform_sampler(lo, hi):
    def sampler(gen, n, device):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    return sampler


def test_make_streams_layout_and_means():
    """Shapes and dtypes are the JAX package's; sample means sit within
    ~6 standard errors of lam, E[size] and 1/mu (bounds stated below)."""
    L, K, A_max, T = 8, 16, 12, 4000
    lam, mu, lo, hi = 3.0, 0.05, 0.1, 0.9
    gen = torch.Generator().manual_seed(7)
    st = make_streams(gen, lam, mu, uniform_sampler(lo, hi), L=L, K=K,
                      A_max=A_max, horizon=T, device="cpu")
    assert st.up is None
    assert st.n.shape == (T,) and st.n.dtype == torch.int32
    assert st.sizes.shape == (T, A_max) and st.sizes.dtype == torch.float32
    assert st.durs.shape == (T, L * K + A_max)
    assert st.durs.dtype == torch.int32
    assert int(st.n.min()) >= 0 and int(st.n.max()) <= A_max
    assert st.num_resources == 1
    # Poisson(3) counts: sd/sqrt(T) = 0.027 -> bound 0.15
    assert abs(st.n.double().mean().item() - lam) < 0.15
    # U(0.1, 0.9): sd 0.23 over 48k draws -> bound 0.01
    assert abs(st.sizes.double().mean().item() - (lo + hi) / 2) < 0.01
    assert float(st.sizes.min()) >= lo and float(st.sizes.max()) <= hi
    # geometric durations >= 1, mean 1/mu = 20, sd ~19.5 over 544k -> 0.2
    assert int(st.durs.min()) >= 1
    assert abs(st.durs.double().mean().item() - 1 / mu) < 0.2


def test_make_streams_seeded_and_fault_plane_after_jobs():
    kw = dict(lam=1.5, mu=0.02, sampler=uniform_sampler(0.05, 0.5), L=4,
              K=6, A_max=6, horizon=50, device="cpu")
    a = make_streams(torch.Generator().manual_seed(3), **kw)
    b = make_streams(torch.Generator().manual_seed(3), fault_rate=0.1,
                     repair_rate=0.5, **kw)
    for x, y in zip(a[:3], b[:3]):  # faults never perturb the job streams
        assert torch.equal(x, y)
    assert b.up.shape == (50, 4) and b.up.dtype == torch.bool
    with pytest.raises(ValueError, match="fault_rate"):
        make_streams(torch.Generator(), fault_rate=-1.0, **kw)


def test_make_streams_rejects_bad_sampler_shape():
    def bad(gen, n, device):
        return torch.rand(n, 2, generator=gen, device=device)
    with pytest.raises(ValueError, match="sampler produced sizes"):
        make_streams(torch.Generator(), 1.0, 0.1, bad, L=2, K=2, A_max=2,
                     horizon=3, device="cpu")


def test_make_fault_plane_markov_availability():
    up = make_fault_plane(torch.Generator().manual_seed(0), L=64,
                          horizon=2000, fault_rate=0.1, repair_rate=0.3,
                          device="cpu")
    assert up.shape == (2000, 64) and up.dtype == torch.bool
    # stationary availability 0.3 / 0.4 = 0.75
    assert abs(up[200:].double().mean().item() - 0.75) < 0.03


def test_fault_plane_from_events_matches_jax():
    events = [(5, 1, False), (2, 0, False), (9, 1, True), (3, 0, True)]
    got = fault_plane_from_events(events, horizon=12, L=3, device="cpu")
    want = np.asarray(jstreams.fault_plane_from_events(events, 12, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="outside horizon"):
        fault_plane_from_events([(12, 0, False)], 12, 3, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        fault_plane_from_events([(0, 3, False)], 12, 3, device="cpu")


def test_with_fault_plane_validates_time_axis():
    st = SchedStreams(torch.zeros(5, dtype=torch.int32),
                      torch.zeros(5, 2), torch.ones(5, 6, dtype=torch.int32))
    assert with_fault_plane(st, np.ones((5, 2), bool)).up.dtype == torch.bool
    with pytest.raises(ValueError, match="fault plane must be"):
        with_fault_plane(st, np.ones((4, 2), bool))


def test_constants_match_jax():
    assert INF_SLOT == int(jstreams.INF_SLOT)
    for w, a in [(None, 8), (3, 8), (None, 48)]:
        assert resolve_work_steps(w, a) == jstreams.resolve_work_steps(w, a)
    assert PolicyResult._fields == jstreams.PolicyResult._fields
    assert SchedStreams._fields == jstreams.SchedStreams._fields


def test_workload_checks():
    wl = Workload(lam=1.0, mu=0.5, sampler=uniform_sampler(0.1, 0.2))
    wl.check_sampler()
    wl.require_scalar("bfjs")
    assert wl.capacity == (1.0,) and wl.mean_service == 2.0
    bad = Workload(lam=1.0, mu=0.5, sampler=lambda g, n, d: torch.zeros(n, 3))
    with pytest.raises(ValueError, match="sampler output shape"):
        bad.check_sampler()
    with pytest.raises(ValueError, match="single-resource"):
        Workload(lam=1.0, mu=0.5, sampler=None, num_resources=2
                 ).require_scalar("bfjs")
    with pytest.raises(ValueError, match="unit server capacity"):
        Workload(lam=1.0, mu=0.5, sampler=None, capacity=2.0
                 ).require_scalar("bfjs")
    for kw in (dict(lam=-1.0, mu=0.5), dict(lam=1.0, mu=0.0)):
        with pytest.raises(ValueError):
            Workload(sampler=None, **kw)


@pytest.mark.parametrize("K", [6, 8, 16, 24])
def test_row_sum_lr_matches_xla_row_sums(K):
    """Hazard (a): the port's explicit left-to-right chain equals XLA's
    float32 row sum bit for bit, as the scan engine evaluates it (jitted,
    on rows with empty slots), where torch.sum may not."""
    rng = np.random.default_rng(K)
    srv = rng.uniform(0.05, 0.5, (512, K)).astype(np.float32)
    srv[rng.random((512, K)) < 0.3] = 0.0
    want = np.asarray(jax.jit(lambda s: 1.0 - s.sum(axis=1))(srv))
    got = (1.0 - row_sum_lr(torch.from_numpy(srv))).numpy()
    np.testing.assert_array_equal(got, want)


def test_first_empty_positions_matches_jax():
    rng = np.random.default_rng(0)
    empty = rng.random((4, 32)) < 0.4
    want = rng.random((4, 10)) < 0.7
    pos, landed = first_empty_positions(torch.from_numpy(empty),
                                        torch.from_numpy(want))
    for g in range(4):
        jp, jl = jops.first_empty_positions(jnp.asarray(empty[g]),
                                            jnp.asarray(want[g]))
        np.testing.assert_array_equal(landed[g].numpy(), np.asarray(jl))
        m = np.asarray(jl)
        np.testing.assert_array_equal(pos[g].numpy()[m], np.asarray(jp)[m])


def test_best_fit_primitives_match_jax():
    rng = np.random.default_rng(1)
    resid = rng.uniform(0, 1, (3, 16)).astype(np.float32)
    resid[:, 3] = resid[:, 7]  # a tie: lowest index wins
    sizes = rng.uniform(0.01, 0.8, (3, 24)).astype(np.float32)
    a, r = best_fit_place(torch.from_numpy(resid), torch.from_numpy(sizes))
    for g in range(3):
        ja, jr = jops.best_fit_place(jnp.asarray(resid[g]),
                                     jnp.asarray(sizes[g]))
        np.testing.assert_array_equal(a[g].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(r[g].numpy(), np.asarray(jr))
        s = best_fit_server(torch.from_numpy(resid[g]),
                            torch.tensor(sizes[g, 0]))
        assert int(s) == int(jops.best_fit_server(jnp.asarray(resid[g]),
                                                  sizes[g, 0]))
    assert int(best_fit_server(torch.tensor([0.1, 0.2]),
                               torch.tensor(0.5))) == -1


def test_largest_fitting_job_matches_jax():
    rng = np.random.default_rng(2)
    queue = rng.uniform(0.05, 0.9, (5, 20)).astype(np.float32)
    queue[rng.random((5, 20)) < 0.3] = 0.0
    queue[:, 4] = queue[:, 9]
    caps = np.array([0.0, 0.3, 0.5, 0.95, 1.0], np.float32)
    got = largest_fitting_job(torch.from_numpy(queue), torch.from_numpy(caps))
    for g in range(5):
        assert int(got[g]) == int(jops.largest_fitting_job(
            jnp.asarray(queue[g]), caps[g]))


def test_convert_round_trip():
    st = streams_from_numpy(np.ones((2, 3), np.int64),
                            np.zeros((2, 3, 2), np.float64),
                            np.ones((2, 3, 6), np.int64),
                            up=np.ones((2, 3, 2), np.int8), device="cpu")
    assert [x.dtype for x in st] == [torch.int32, torch.float32, torch.int32,
                                     torch.bool]
    res = PolicyResult(torch.zeros(3, dtype=torch.int32), torch.zeros(3),
                       torch.zeros(3, dtype=torch.int32), torch.tensor(0),
                       torch.tensor(0))
    out = result_to_numpy(res)
    assert isinstance(out.queue_len, np.ndarray) and out.preempted is None


@pytest.mark.parametrize("J", [2, 4, 7])
def test_vq_type_of_grid_matches_jax_at_every_grid_point(J):
    """The VQS classifier, comparison for comparison, on every grid size
    1..RES (and the float front end on the same points)."""
    from repro_torch.core.engine import vq_type_of, vq_type_of_grid
    from repro_torch.core.quantize import RES
    g = np.arange(1, RES + 1, dtype=np.int32)
    want = np.asarray(jops.vq_type_of_grid(jnp.asarray(g), J))
    np.testing.assert_array_equal(
        vq_type_of_grid(torch.from_numpy(g), J).numpy(), want)
    sizes = (g / RES).astype(np.float32)
    np.testing.assert_array_equal(
        vq_type_of(torch.from_numpy(sizes), J).numpy(),
        np.asarray(jops.vq_type_of(jnp.asarray(sizes), J)))


def test_k_red_and_max_weight_config_match_jax():
    from repro.core.partition import k_red as j_k_red
    from repro_torch.core.engine import k_red_t, max_weight_config
    from repro_torch.core.partition import k_red
    from repro_torch.core.quantize import RES, TWO_THIRDS, to_grid
    from repro.core import quantize as jq
    assert (RES, TWO_THIRDS) == (jq.RES, jq.TWO_THIRDS)
    np.testing.assert_array_equal(to_grid([0.3, 1e-9, 1.0, 0.5]),
                                  jq.to_grid([0.3, 1e-9, 1.0, 0.5]))
    for J in range(2, 9):
        np.testing.assert_array_equal(k_red(J), j_k_red(J))
        assert k_red_t(J).dtype == torch.int32
    assert k_red(4).shape == (12, 8) and k_red(7).shape == (24, 14)
    with pytest.raises(ValueError):
        k_red(1)
    rng = np.random.default_rng(5)
    for J in (2, 4, 7):
        q = rng.integers(0, 6, (64, 2 * J)).astype(np.int32)
        q[0] = 0  # all-zero weights: the first row wins
        i, row = max_weight_config(k_red_t(J), torch.from_numpy(q))
        for b in range(64):
            ji, jrow = jops.max_weight_config_jax(J, jnp.asarray(q[b]))
            assert int(i[b]) == int(ji)
            np.testing.assert_array_equal(row[b].numpy(), np.asarray(jrow))


def test_streams_from_trace_matches_jax():
    """Raw arrays (unsorted slots, sizes off the grid, durations below 1):
    the same stable sort, quantization and clamps as JAX; a smaller A_max
    raises instead of dropping jobs."""
    from repro_torch.core.engine import streams_from_trace
    rng = np.random.default_rng(3)
    slots = rng.integers(0, 40, 200)
    sizes = rng.uniform(0.0, 1.0, 200)
    durs = rng.integers(-2, 30, 200)
    for kw in (dict(), dict(horizon=30), dict(A_max=20)):
        got = streams_from_trace(slots, sizes, durs, device="cpu", **kw)
        want = jstreams.streams_from_trace(slots, sizes, durs, **kw)
        for f in ("n", "sizes", "durs"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{kw} {f}")
        assert got.n.dtype == torch.int32 and got.durs.dtype == torch.int32
    with pytest.raises(ValueError, match="raise A_max"):
        streams_from_trace(slots, sizes, durs, A_max=2, device="cpu")
    with pytest.raises(TypeError, match="not both"):
        from types import SimpleNamespace
        streams_from_trace(SimpleNamespace(arrival_slots=slots, sizes=sizes,
                                           durations=durs), sizes,
                           device="cpu")
    with pytest.raises(ValueError, match="empty trace"):
        streams_from_trace(np.zeros(0), np.zeros(0), np.zeros(0),
                           device="cpu")


def test_make_streams_resource_vectors():
    """R > 1: sizes (T, A_max, R) from an (n, R) sampler; the counts, drawn
    first, do not depend on R and the durations keep their layout; a
    sampler of the wrong width raises, naming both shapes."""
    kw = dict(lam=1.5, mu=0.05, L=3, K=4, A_max=5, horizon=40, device="cpu")

    def vec(R):
        def sampler(gen, n, device):
            return torch.rand(n, R, generator=gen, device=device)
        return sampler
    one = make_streams(torch.Generator().manual_seed(2),
                       sampler=uniform_sampler(0.0, 1.0), **kw)
    two = make_streams(torch.Generator().manual_seed(2), sampler=vec(2),
                       num_resources=2, **kw)
    assert two.sizes.shape == (40, 5, 2) and two.num_resources == 2
    assert two.sizes.dtype == torch.float32
    assert torch.equal(one.n, two.n) and two.durs.shape == one.durs.shape
    with pytest.raises(ValueError, match=r"\(200, 2\).*expected \(200, 3\)"):
        make_streams(torch.Generator(), sampler=vec(2), num_resources=3,
                     **kw)
    from repro_torch.core.engine import ensemble_streams
    ens = ensemble_streams([2, 3], sampler=vec(2), num_resources=2, **kw)
    assert ens.sizes.shape == (2, 40, 5, 2)
    assert torch.equal(ens.sizes[0], two.sizes)


def test_streams_from_trace_resource_modes_match_jax():
    """A (cpu, mem) trace collapsed (max) or kept as (T, A_max, 2) demand
    vectors, and raw (N, R) arrays: the JAX arrays; a resource count that
    does not match num_resources raises with the JAX hint."""
    from repro.core import synthesize_google_like_trace
    from repro_torch.core.engine import streams_from_trace
    trace = synthesize_google_like_trace(300, 300, seed=1)
    for kw in (dict(), dict(collapse=False), dict(collapse=False,
                                                  num_resources=2),
               dict(num_resources=1)):
        got = streams_from_trace(trace, device="cpu", **kw)
        want = jstreams.streams_from_trace(trace, **kw)
        for f in ("n", "sizes", "durs"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{kw} {f}")
    unc = streams_from_trace(trace, collapse=False, device="cpu")
    assert unc.num_resources == 2 and unc.sizes.ndim == 3
    np.testing.assert_array_equal(
        streams_from_trace(trace, device="cpu").sizes.numpy(),
        unc.sizes.numpy().max(axis=-1))
    rng = np.random.default_rng(4)
    slots, dem = rng.integers(0, 30, 90), rng.uniform(0.0, 1.0, (90, 3))
    durs = rng.integers(-1, 20, 90)
    got = streams_from_trace(slots, dem, durs, device="cpu")
    want = jstreams.streams_from_trace(slots, dem, durs)
    for f in ("n", "sizes", "durs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.sizes.shape[-1] == 3
    with pytest.raises(ValueError, match=r"collapse=True"):
        streams_from_trace(trace, collapse=False, num_resources=1,
                           device="cpu")
    with pytest.raises(ValueError, match=r"collapse=False"):
        streams_from_trace(trace, num_resources=2, device="cpu")
    with pytest.raises(ValueError, match="R=3"):
        streams_from_trace(slots, dem, durs, num_resources=2, device="cpu")
