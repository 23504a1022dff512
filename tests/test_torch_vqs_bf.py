"""VQS-BF engines of the port vs the JAX package on shared streams.

As for VQS, every field — occupancy included — must be equal: the
engines compute on the int32 RES grid only."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import load_trace_csv  # noqa: E402
from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import streams_from_trace as j_sft  # noqa: E402
from repro.core.engine.vqs_bf import \
    run_vqs_bf_streams as j_run  # noqa: E402
from repro.kernels.vqs_bf.ops import \
    vqs_bf_simulate as j_vqs_bf_simulate  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy,
                                 vqs_bf_state_from_numpy)
from repro_torch.core.engine import (Workload,  # noqa: E402
                                     monte_carlo_policy, run_policy_streams,
                                     run_vqs_bf_streams, run_vqs_streams,
                                     streams_from_trace)
from repro_torch.kernels.common import \
    GracefulDegradationWarning  # noqa: E402
from repro_torch.kernels.vqs_bf import vqs_bf as vqs_bf_kernel  # noqa: E402
from repro_torch.kernels.vqs_bf.ops import (  # noqa: E402
    vqs_bf_scratch_bytes, vqs_bf_simulate)

FIELDS = ("queue_len", "occupancy", "departed", "dropped", "truncated",
          "preempted", "requeued", "lost")
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")
WORK = 64  # one placement per step: sized to the per-slot burst
_OVERFLOW_J = 3


def _overflow_trace():
    """Every job the smallest type; K = 2 slots per server take only two
    of the 2**J a configuration packs (the trace of
    tests/test_vqs_engine.py::test_vqs_server_slot_overflow_is_counted)."""
    T = 120
    slots = np.sort(np.arange(40) % T)
    return (slots, np.full(40, 1.0 / (1 << _OVERFLOW_J)), np.full(40, 100),
            T)


def _uniform(lo, hi):
    def sampler(key, n):
        return jax.random.uniform(key, (n,), minval=lo, maxval=hi)
    return sampler


def _jax_streams(G, L, K, A_max, T, lam=1.0, mu=0.03, seed=9,
                 fault_rate=0.0, lo=0.05, hi=0.9):
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [j_make_streams(k, lam, mu, _uniform(lo, hi), L=L, K=K,
                           A_max=A_max, horizon=T, fault_rate=fault_rate,
                           repair_rate=0.3)
            for k in keys]


def _stack(sts):
    return [np.stack([np.asarray(getattr(s, f)) for s in sts])
            for f in ("n", "sizes", "durs")]


def _to_port(sts):
    up = None if sts[0].up is None else \
        np.stack([np.asarray(s.up) for s in sts])
    return streams_from_numpy(*_stack(sts), up=up, device="cpu")


def _assert_equal(port, refs):
    for g, ref in enumerate(refs):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(port, f)[g],
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"member {g} field {f}")


@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,W,fault_rate", [
    (2, 2, 3, 6, 32, 4, 180, 1.0, 0.03, None, 0.0),
    (2, 3, 4, 8, 48, 5, 120, 1.0, 0.03, None, 0.0),
    (1, 4, 6, 16, 64, 6, 90, 1.0, 0.03, None, 0.0),
    (2, 3, 3, 8, 8, 6, 150, 4.0, 0.01, 2, 0.0),    # overload
    (2, 3, 5, 8, 48, 5, 150, 1.0, 0.03, None, 0.05),  # fault plane
    (2, 3, 4, 3, 48, 6, 150, 1.5, 0.03, None, 0.0),  # K < 2^J: K-overflow
    (1, 10, 4, 8, 48, 5, 100, 1.0, 0.03, None, 0.0),  # 36 K_RED rows, 20 VQs
])
def test_scan_engine_matches_jax(G, J, L, K, Qcap, A_max, T, lam, mu, W,
                                 fault_rate):
    sts = _jax_streams(G, L, K, A_max, T, lam=lam, mu=mu,
                       seed=4 if lam == 4.0 else 9, fault_rate=fault_rate)
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=W)
    refs = [j_run(s, **kw) for s in sts]
    port = result_to_numpy(run_vqs_bf_streams(_to_port(sts), **kw))
    _assert_equal(port, refs)
    if lam == 4.0:
        assert port.dropped.sum() > 0 and port.truncated.sum() > 0
    if lam == 1.5:  # K < 2^J: a server cannot hold what a row packs
        assert port.truncated.sum() > 0
    if fault_rate:
        assert port.preempted.sum() > 0
        np.testing.assert_array_equal(port.preempted,
                                      port.requeued + port.lost)


def test_scan_engine_resumes_from_jax_carry():
    L, K, Qcap, A_max, T, J = 4, 8, 48, 5, 160, 3
    st = _jax_streams(1, L, K, A_max, T, fault_rate=0.04)[0]
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max)
    full = j_run(st, **kw)
    h = T // 2
    first, carry = j_run(jax.tree.map(lambda x: x[:h], st),
                         return_state=True, **kw)
    rest = jax.tree.map(lambda x: x[h:], st)
    state = vqs_bf_state_from_numpy([np.asarray(x) for x in carry],
                                    device="cpu")
    port = result_to_numpy(run_vqs_bf_streams(
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
    assert int(full.preempted) > 0


def test_scan_engine_returns_the_jax_carry():
    L, K, Qcap, A_max, T, J = 3, 6, 32, 4, 120, 2
    st = _jax_streams(1, L, K, A_max, T)[0]
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max)
    _, carry = j_run(st, return_state=True, **kw)
    _, state = run_vqs_bf_streams(
        streams_from_numpy(st.n, st.sizes, st.durs, device="cpu"),
        return_state=True, **kw)
    for name, x, y in zip(state._fields, state, carry):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=name)


# (G, J, L, K, Qcap, A_max, T, lam, mu, lo, hi, W): a windowed grid, then
# the streams the CUDA kernel's card tests probe its design with — one size
# everywhere (pops tie on size and go by sequence stamp), full rows (K <
# 2^J: K-overflow), a deep queue that drops arrivals, and a two-step work
# list that cuts slots short
@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,lo,hi,W", [
    pytest.param(2, 3, 4, 8, 48, 5, 100, 1.0, 0.03, 0.05, 0.9, None,
                 id="windowed"),
    pytest.param(2, 3, 5, 8, 48, 5, 100, 1.5, 0.03, 0.25, 0.25, None,
                 id="constant-sizes"),
    pytest.param(2, 3, 4, 3, 48, 6, 100, 1.5, 0.03, 0.05, 0.9, None,
                 id="k-overflow"),
    pytest.param(2, 3, 3, 8, 8, 6, 100, 4.0, 0.01, 0.05, 0.9, None,
                 id="deep-queue-drops"),
    pytest.param(2, 3, 3, 8, 48, 6, 100, 4.0, 0.01, 0.05, 0.9, 2,
                 id="two-step-list"),
])
def test_plain_version_matches_pallas(G, J, L, K, Qcap, A_max, T, lam, mu,
                                      lo, hi, W):
    """The kernel wrapper on CPU tensors (its plain version) == the JAX
    Pallas kernel in interpret mode."""
    from repro.core.engine import SchedStreams as JStreams
    sts = _jax_streams(G, L, K, A_max, T, lam=lam, mu=mu, lo=lo, hi=hi)
    n, sizes, durs = _stack(sts)
    ref = j_vqs_bf_simulate(JStreams(n, sizes, durs), J=J, L=L, K=K,
                            Qcap=Qcap, A_max=A_max, work_steps=W, window=50)
    before = vqs_bf_kernel.launches.count
    port = result_to_numpy(vqs_bf_simulate(
        streams_from_numpy(n, sizes, durs, device="cpu"), J=J, L=L, K=K,
        Qcap=Qcap, A_max=A_max, work_steps=W, window=50))
    assert vqs_bf_kernel.launches.count == before  # CPU: plain version
    for f in FIELDS[:5]:
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    if K < 1 << J or W == 2:
        assert port.truncated.sum() > 0
    if Qcap == 8:
        assert port.dropped.sum() > 0


def test_server_slot_overflow_is_counted():
    """K < 2^J: every pop a full server cannot take is counted in
    ``truncated`` by the scan engine and the kernel's plain version, as
    JAX counts it."""
    slots, sizes, durs, T = _overflow_trace()
    jst = j_sft(slots, sizes, durs, horizon=T)
    pst = streams_from_trace(slots, sizes, durs, horizon=T, device="cpu")
    kw = dict(J=_OVERFLOW_J, L=1, K=2, Qcap=64, A_max=int(pst.sizes.shape[1]))
    ref = j_run(jst, **kw)
    assert int(ref.truncated) > 0
    for res in (run_vqs_bf_streams(pst, **kw),
                vqs_bf_simulate(pst._replace(**{
                    f: getattr(pst, f)[None] for f in ("n", "sizes",
                                                       "durs")}), **kw)):
        port = result_to_numpy(res)
        for f in FIELDS[:5]:
            np.testing.assert_array_equal(
                np.asarray(getattr(port, f)).reshape(
                    np.shape(getattr(ref, f))),
                np.asarray(getattr(ref, f)), err_msg=f)


def test_trace_fixture_matches_jax():
    """google_like_50.csv replays through the port as through JAX."""
    trace = load_trace_csv(FIXTURE, slot_seconds=10.0)
    T = int(trace.arrival_slots[-1]) + 80
    jst = j_sft(trace, horizon=T)
    pst = streams_from_trace(trace, horizon=T, device="cpu")
    kw = dict(J=3, L=8, K=8, Qcap=256, A_max=int(pst.sizes.shape[1]),
              work_steps=WORK)
    ref = j_run(jst, **kw)
    port = result_to_numpy(run_policy_streams(pst, policy="vqs-bf",
                                              engine="cuda", **kw))
    _assert_equal(type(port)(*(None if x is None else x[None]
                               for x in port)), [ref])
    assert int(ref.truncated) == 0 and int(ref.departed[-1]) > 0


def test_tail_well_below_vqs_tail_on_shared_streams():
    """The paper's Section VI claim on the port (as
    tests/test_vqs_bf_engine.py checks it on JAX): on the same streams at
    a stable load, VQS-BF's backfilled queue sits far below VQS's."""
    st = _to_port(_jax_streams(1, 6, 40, 6, 1000, lam=0.3, mu=0.05, seed=3))
    kw = dict(J=3, L=6, K=40, Qcap=2048, A_max=6)
    vqs = result_to_numpy(run_vqs_streams(st, **kw))
    vqsbf = result_to_numpy(run_vqs_bf_streams(st, work_steps=WORK, **kw))
    assert int(vqs.truncated.sum()) == 0 and int(vqsbf.truncated.sum()) == 0
    tail_vqs = float(np.mean(vqs.queue_len[0, 200:]))
    tail_bf = float(np.mean(vqsbf.queue_len[0, 200:]))
    assert tail_bf < 0.6 * tail_vqs
    assert vqsbf.queue_len.max() <= vqs.queue_len.max()


def test_cuda_engine_on_cpu_and_its_gate():
    wl = Workload(lam=1.0, mu=0.03, sampler=lambda gen, n, device:
                  torch.rand(n, generator=gen, device=device) * 0.85 + 0.05)
    cfg = dict(J=3, L=4, K=8, Qcap=48, A_max=5, horizon=60, device="cpu")
    before = vqs_bf_kernel.launches.count
    cuda = monte_carlo_policy(wl, seeds=[0, 1], policy="vqs-bf",
                              engine="cuda", strict=True, **cfg)
    scan = monte_carlo_policy(wl, seeds=[0, 1], policy="vqs-bf",
                              engine="scan", **cfg)
    assert vqs_bf_kernel.launches.count == before
    for x, y in zip(result_to_numpy(cuda), result_to_numpy(scan)):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="fault-plane"):
        monte_carlo_policy(wl, seeds=[0], policy="vqs-bf", engine="cuda",
                           strict=True, fault_rate=0.05, **cfg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        monte_carlo_policy(wl, seeds=[0], policy="vqs-bf", engine="cuda",
                           fault_rate=0.05, **cfg)
    assert any(issubclass(x.category, GracefulDegradationWarning)
               for x in w)
    # K = 2^J at J = 8 (the paper's rule for K) runs, strict or not;
    # past the kernel's 16-bit counts it raises
    wide = monte_carlo_policy(wl, seeds=[0], policy="vqs-bf", engine="cuda",
                              strict=True, **{**cfg, "J": 8, "K": 256})
    assert wide.queue_len.shape == (1, 60)
    for strict in (True, False):
        with pytest.raises(NotImplementedError, match="65535 jobs"):
            monte_carlo_policy(wl, seeds=[0], policy="vqs-bf",
                               engine="cuda", strict=strict,
                               **{**cfg, "K": 1 << 16})


@pytest.mark.cuda
def test_scratch_bytes_fit_the_slice_and_fig5_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layout is read from the "
                    "built kernel")
    from repro_torch.kernels.common import SMEM_LIMIT_BYTES
    from repro_torch.kernels.vqs.vqs import load
    ws = load("vqs_bf").vqs_bf_workspace_bytes
    # the (L, K) departure slots alone: rings and the packed job plane fit
    # in shared memory at the slice's shape
    jobs = 4 * 1000 * 16
    assert ws(4, 1000, 16, 1024, 48) == jobs
    for J, Qcap in ((4, 1024), (7, 1024), (7, 4096), (4, 4096)):
        assert vqs_bf_scratch_bytes(J, 1000, 16, Qcap, 48) \
            <= SMEM_LIMIT_BYTES
    assert ws(7, 1000, 16, 4096, 48) > jobs
    # K = 64: the packed job plane joins the departure slots there
    assert ws(4, 1000, 64, 1024, 48) == 2 * 4 * 1000 * 64
