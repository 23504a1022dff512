"""VQS engines of the port vs the JAX package on shared streams.

Streams come from the JAX ``make_streams`` (or ``streams_from_trace``) and
reach the port through ``repro_torch.convert`` on the CPU.  Everything is
integer arithmetic on the RES grid, so every field — occupancy included —
must be equal, with no tolerance."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import load_trace_csv  # noqa: E402
from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import streams_from_trace as j_sft  # noqa: E402
from repro.core.engine.vqs import run_vqs_streams as j_run  # noqa: E402
from repro.kernels.vqs.ops import vqs_simulate as j_vqs_simulate  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy, vqs_state_from_numpy)
from repro_torch.core.engine import (Workload,  # noqa: E402
                                     monte_carlo_policy, run_policy_streams,
                                     run_vqs_streams, streams_from_trace)
from repro_torch.kernels.common import \
    GracefulDegradationWarning  # noqa: E402
from repro_torch.kernels.vqs import vqs as vqs_kernel  # noqa: E402
from repro_torch.kernels.vqs.ops import (vqs_scratch_bytes,  # noqa: E402
                                         vqs_simulate)

_OVERFLOW_J = 3


def _overflow_trace():
    """Every job the smallest type, so a server packs 2**J of them; with
    K = 2 slots the placements past the second are K-overflow (the trace of
    tests/test_vqs_engine.py::test_vqs_server_slot_overflow_is_counted)."""
    T = 120
    slots = np.sort(np.arange(40) % T)
    return (slots, np.full(40, 1.0 / (1 << _OVERFLOW_J)), np.full(40, 100),
            T)

FIELDS = ("queue_len", "occupancy", "departed", "dropped", "truncated",
          "preempted", "requeued", "lost")
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")


def _sampler(key, n):
    return jax.random.uniform(key, (n,), minval=0.05, maxval=0.9)


def _jax_streams(G, L, K, A_max, T, lam=1.0, mu=0.03, seed=9,
                 fault_rate=0.0):
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [j_make_streams(k, lam, mu, _sampler, L=L, K=K, A_max=A_max,
                           horizon=T, fault_rate=fault_rate, repair_rate=0.3)
            for k in keys]


def _stack(sts):
    return [np.stack([np.asarray(getattr(s, f)) for s in sts])
            for f in ("n", "sizes", "durs")]


def _to_port(sts):
    up = None if sts[0].up is None else \
        np.stack([np.asarray(s.up) for s in sts])
    return streams_from_numpy(*_stack(sts), up=up, device="cpu")


def _assert_equal(port, refs):
    """port: batched numpy PolicyResult; refs: per-member JAX results."""
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
    port = result_to_numpy(run_vqs_streams(_to_port(sts), **kw))
    _assert_equal(port, refs)
    if lam == 4.0:  # mirrors tests/test_kernels.py: drops and truncation
        assert port.dropped.sum() > 0 and port.truncated.sum() > 0
    if lam == 1.5:  # K < 2^J: a server cannot hold what a row packs
        assert port.truncated.sum() > 0
    if fault_rate:
        assert port.preempted.sum() > 0
        np.testing.assert_array_equal(port.preempted,
                                      port.requeued + port.lost)


def test_scan_engine_resumes_from_jax_carry():
    """Slot 0..T/2 on JAX, the carry handed over, T/2..T on the port ==
    JAX straight through (departures restart per slice)."""
    L, K, Qcap, A_max, T, J = 4, 8, 48, 5, 160, 3
    st = _jax_streams(1, L, K, A_max, T, fault_rate=0.04)[0]
    kw = dict(J=J, L=L, K=K, Qcap=Qcap, A_max=A_max)
    full = j_run(st, **kw)
    h = T // 2
    first, carry = j_run(jax.tree.map(lambda x: x[:h], st),
                         return_state=True, **kw)
    rest = jax.tree.map(lambda x: x[h:], st)
    state = vqs_state_from_numpy([np.asarray(x) for x in carry],
                                 device="cpu")
    port = run_vqs_streams(
        streams_from_numpy(rest.n, rest.sizes, rest.durs, up=rest.up,
                           device="cpu"), state=state, **kw)
    port = result_to_numpy(port)
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
    _, state = run_vqs_streams(
        streams_from_numpy(st.n, st.sizes, st.durs, device="cpu"),
        return_state=True, **kw)
    for name, x, y in zip(state._fields, state, carry):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=name)


# (G, J, L, K, Qcap, A_max, T, lam, mu, seed): a windowed grid, J = 2, a
# stream whose queues build up (packing bursts from deep rings), and J = 7
# (14 rings, 24 K_RED rows)
@pytest.mark.parametrize("G,J,L,K,Qcap,A_max,T,lam,mu,seed", [
    pytest.param(2, 3, 4, 8, 48, 5, 120, 1.0, 0.03, 9, id="windowed"),
    pytest.param(2, 2, 4, 8, 48, 5, 120, 1.0, 0.03, 4, id="j2"),
    pytest.param(2, 3, 3, 8, 64, 6, 120, 2.5, 0.03, 5, id="queueing"),
    pytest.param(2, 7, 4, 16, 48, 5, 120, 1.0, 0.03, 6, id="j7"),
])
def test_plain_version_matches_pallas(G, J, L, K, Qcap, A_max, T, lam, mu,
                                      seed):
    """The kernel wrapper on CPU tensors (its plain version) == the JAX
    Pallas kernel in interpret mode, as tests/test_kernels.py runs it."""
    from repro.core.engine import SchedStreams as JStreams
    sts = _jax_streams(G, L, K, A_max, T, lam=lam, mu=mu, seed=seed)
    n, sizes, durs = _stack(sts)
    ref = j_vqs_simulate(JStreams(n, sizes, durs), J=J, L=L, K=K, Qcap=Qcap,
                         A_max=A_max, window=60)
    before = vqs_kernel.launches.count
    port = result_to_numpy(vqs_simulate(
        streams_from_numpy(n, sizes, durs, device="cpu"), J=J, L=L, K=K,
        Qcap=Qcap, A_max=A_max, window=60))
    assert vqs_kernel.launches.count == before  # CPU: plain version
    for f in FIELDS[:5]:
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert port.departed[:, -1].min() > 0
    if lam > 2:
        assert port.queue_len.mean() > 1


def test_server_slot_overflow_is_counted():
    """K < 2^J: the scan engine and the kernel's plain version count every
    placement a full server cannot take in ``truncated``, as JAX does."""
    slots, sizes, durs, T = _overflow_trace()
    jst = j_sft(slots, sizes, durs, horizon=T)
    pst = streams_from_trace(slots, sizes, durs, horizon=T, device="cpu")
    kw = dict(J=_OVERFLOW_J, L=1, K=2, Qcap=64, A_max=int(pst.sizes.shape[1]))
    ref = j_run(jst, **kw)
    assert int(ref.truncated) > 0
    for res in (run_vqs_streams(pst, **kw),
                vqs_simulate(pst._replace(**{
                    f: getattr(pst, f)[None] for f in ("n", "sizes",
                                                       "durs")}), **kw)):
        port = result_to_numpy(res)
        for f in FIELDS[:5]:
            np.testing.assert_array_equal(
                np.asarray(getattr(port, f)).reshape(
                    np.shape(getattr(ref, f))),
                np.asarray(getattr(ref, f)), err_msg=f)


def test_trace_fixture_matches_jax():
    """google_like_50.csv through the port's streams_from_trace gives the
    JAX arrays, and the VQS trajectory on them equals JAX's."""
    trace = load_trace_csv(FIXTURE, slot_seconds=10.0)
    T = int(trace.arrival_slots[-1]) + 80
    jst = j_sft(trace, horizon=T)
    pst = streams_from_trace(trace, horizon=T, device="cpu")
    for f in ("n", "sizes", "durs"):
        np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert pst.up is None and pst.durs.shape == pst.sizes.shape
    kw = dict(J=3, L=8, K=8, Qcap=256, A_max=int(pst.sizes.shape[1]))
    ref = j_run(jst, **kw)
    port = result_to_numpy(run_policy_streams(pst, policy="vqs",
                                              engine="cuda", **kw))
    _assert_equal(type(port)(*(None if x is None else x[None]
                               for x in port)), [ref])
    assert int(ref.departed[-1]) > 0


def test_cuda_engine_on_cpu_and_its_gate():
    """On CPU tensors engine="cuda" is the plain version (no launch); a
    fault plane moves loudly to the scan engine, or raises when strict."""
    wl = Workload(lam=1.0, mu=0.03, sampler=lambda gen, n, device:
                  torch.rand(n, generator=gen, device=device) * 0.85 + 0.05)
    cfg = dict(J=3, L=4, K=8, Qcap=48, A_max=5, horizon=60, device="cpu")
    before = vqs_kernel.launches.count
    cuda = monte_carlo_policy(wl, seeds=[0, 1], policy="vqs",
                              engine="cuda", strict=True, **cfg)
    scan = monte_carlo_policy(wl, seeds=[0, 1], policy="vqs", engine="scan",
                              **cfg)
    assert vqs_kernel.launches.count == before
    for x, y in zip(result_to_numpy(cuda), result_to_numpy(scan)):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="fault-plane"):
        monte_carlo_policy(wl, seeds=[0], policy="vqs", engine="cuda",
                           strict=True, fault_rate=0.05, **cfg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = monte_carlo_policy(wl, seeds=[0], policy="vqs", engine="cuda",
                                 fault_rate=0.05, **cfg)
    assert any(issubclass(x.category, GracefulDegradationWarning)
               for x in w)
    assert res.queue_len.shape == (1, 60)
    # every J of the grid runs, strict or not; past it the kernel raises
    wide = monte_carlo_policy(wl, seeds=[0], policy="vqs", engine="cuda",
                              strict=True, **{**cfg, "J": 16})
    assert wide.queue_len.shape == (1, 60)
    for strict in (True, False):
        with pytest.raises(NotImplementedError, match="J <= 16"):
            monte_carlo_policy(wl, seeds=[0], policy="vqs", engine="cuda",
                               strict=strict, **{**cfg, "J": 17})


@pytest.mark.cuda
def test_scratch_bytes_fit_the_slice_and_fig5_shapes():
    """The built kernel's shared memory passes the gate at the slice's
    shape (rings and the packed job plane in shared memory, only the (L, K)
    departure slots in the workspace) and at J=7 with Qcap up to 4096 (the
    rings in the workspace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layout is read from the "
                    "built kernel")
    from repro_torch.kernels.common import SMEM_LIMIT_BYTES
    ws = vqs_kernel.load("vqs").vqs_workspace_bytes
    dep = 4 * 1000 * 16  # the (L, K) departure slots
    assert ws(4, 1000, 16, 1024, 48) == dep
    for J, Qcap in ((4, 1024), (7, 1024), (7, 4096), (4, 4096)):
        assert vqs_scratch_bytes(J, 1000, 16, Qcap, 48) <= SMEM_LIMIT_BYTES
    # sizes and durations of 14 rings of 4096
    assert ws(7, 1000, 16, 4096, 48) == dep + 4 * 2 * 14 * 4096
    # the largest clusters the 512-thread kernel took before its redesign
    # (7 words a server in shared memory) still pass: the per-row
    # bookkeeping moves to the workspace
    for J, L in ((4, 8200), (16, 7900)):
        assert vqs_scratch_bytes(J, L, 16, 1024, 48) <= SMEM_LIMIT_BYTES
