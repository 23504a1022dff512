"""BF-J/S engines of the port vs the JAX package on shared streams.

Streams come from the JAX ``make_streams`` and reach the port through
``repro_torch.convert`` on the CPU.  Integer trajectories and counters
must be equal; occupancy, summed in another order, agrees to rtol=1e-6
(the bar of tests/test_kernels.py)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_bfjs_streams as j_run  # noqa: E402
from repro.kernels.bfjs.bfjs import bfjs_pallas  # noqa: E402
from repro_torch.convert import (bfjs_state_from_numpy,  # noqa: E402
                                 result_to_numpy, streams_from_numpy)
from repro_torch.core.engine import (run_bfjs_streams,  # noqa: E402
                                     run_bfjs_trace)
from repro_torch.kernels.bfjs import bfjs as bfjs_kernel  # noqa: E402
from repro_torch.kernels.bfjs.ops import (bfjs_scratch_bytes,  # noqa: E402
                                          bfjs_simulate)
from repro_torch.kernels.common import (SMEM_LIMIT_BYTES,  # noqa: E402
                                        GracefulDegradationWarning)

EXACT = ("queue_len", "departed", "dropped", "truncated", "preempted",
         "requeued", "lost")


def _sampler(key, n):
    return jax.random.uniform(key, (n,), minval=0.05, maxval=0.5)


def _constant(v):
    def sampler(key, n):
        return jnp.full((n,), v, dtype=jnp.float32)
    return sampler


def _jax_streams(G, L, K, A_max, T, lam=1.2, mu=0.02, seed=0,
                 fault_rate=0.0, sampler=_sampler):
    keys = jax.random.split(jax.random.PRNGKey(seed), G)
    return [j_make_streams(k, lam, mu, sampler, L=L, K=K, A_max=A_max,
                           horizon=T, fault_rate=fault_rate, repair_rate=0.3)
            for k in keys]


def _to_port(sts):
    stack = [np.stack([np.asarray(getattr(s, f)) for s in sts])
             for f in ("n", "sizes", "durs")]
    up = None if sts[0].up is None else \
        np.stack([np.asarray(s.up) for s in sts])
    return streams_from_numpy(*stack, up=up, device="cpu")


def _assert_matches(port, refs, fields=EXACT):
    """port: batched numpy PolicyResult; refs: per-member JAX results."""
    for g, ref in enumerate(refs):
        for f in fields:
            np.testing.assert_array_equal(getattr(port, f)[g],
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"member {g} field {f}")
        np.testing.assert_allclose(port.occupancy[g],
                                   np.asarray(ref.occupancy), rtol=1e-6)


@pytest.mark.parametrize("G,L,K,Qcap,A_max,T,lam,fault_rate", [
    (2, 4, 6, 64, 6, 120, 1.2, 0.0),
    (2, 4, 8, 64, 6, 120, 1.2, 0.0),
    (1, 8, 16, 128, 8, 96, 1.2, 0.0),
    (1, 16, 24, 512, 8, 200, 1.5, 0.0),
    (2, 3, 4, 16, 6, 200, 4.0, 0.0),     # overload: drops + truncation
    (2, 4, 6, 64, 6, 120, 1.2, 0.05),    # fault plane
])
def test_scan_engine_matches_jax(G, L, K, Qcap, A_max, T, lam, fault_rate):
    sts = _jax_streams(G, L, K, A_max, T, lam=lam, mu=0.01 if lam == 4.0
                       else 0.02, seed=3 if lam == 4.0 else 0,
                       fault_rate=fault_rate)
    refs = [j_run(s, L=L, K=K, Qcap=Qcap, A_max=A_max) for s in sts]
    port = result_to_numpy(run_bfjs_streams(_to_port(sts), L=L, K=K,
                                            Qcap=Qcap, A_max=A_max))
    _assert_matches(port, refs)
    if lam == 4.0:
        assert port.dropped.sum() > 0 and port.truncated.sum() > 0
    if fault_rate:
        assert port.preempted.sum() > 0
        np.testing.assert_array_equal(port.preempted,
                                      port.requeued + port.lost)


def test_scan_engine_unbatched_streams():
    st = _jax_streams(1, 4, 6, 6, 80)[0]
    ref = j_run(st, L=4, K=6, Qcap=64, A_max=6)
    one = streams_from_numpy(st.n, st.sizes, st.durs, device="cpu")
    port = result_to_numpy(run_bfjs_streams(one, L=4, K=6, Qcap=64,
                                            A_max=6))
    assert port.queue_len.shape == (80,) and port.dropped.shape == ()
    _assert_matches(type(port)(*(None if x is None else x[None]
                                 for x in port)), [ref])


# (G, L, K, Qcap, A_max, T, window, lam, mu, size, W): windowed grids, then
# the streams the CUDA kernel's card tests probe its design with — one
# size everywhere (residual ties), full rows that still take a job (the
# slot-0 overwrite), a deep queue that drops arrivals, and a two-step work
# list that cuts slots short
@pytest.mark.parametrize("G,L,K,Qcap,A_max,T,window,lam,mu,size,W", [
    pytest.param(2, 4, 6, 64, 6, 120, None, 1.2, 0.02, None, None,
                 id="2-4-6-64-6-120-None"),
    pytest.param(3, 4, 6, 64, 6, 240, 80, 1.2, 0.02, None, None,
                 id="3-4-6-64-6-240-80"),
    pytest.param(1, 8, 4, 32, 4, 96, 32, 1.2, 0.02, None, None,
                 id="1-8-4-32-4-96-32"),
    pytest.param(2, 5, 8, 64, 6, 120, None, 1.5, 0.02, 0.25, None,
                 id="constant-sizes"),
    pytest.param(2, 3, 3, 64, 6, 120, None, 2.0, 0.02, 0.25, None,
                 id="full-rows-overwrite"),
    pytest.param(2, 3, 4, 16, 6, 150, None, 4.0, 0.01, None, None,
                 id="deep-queue-drops"),
    pytest.param(2, 4, 6, 64, 6, 120, None, 2.0, 0.02, None, 2,
                 id="two-step-list"),
])
def test_bfjs_plain_version_matches_pallas(G, L, K, Qcap, A_max, T, window,
                                           lam, mu, size, W):
    """The kernel wrapper on CPU tensors (its plain version) == the JAX
    Pallas kernel in interpret mode, including windowed grids."""
    sts = _jax_streams(G, L, K, A_max, T, lam=lam, mu=mu,
                       sampler=_sampler if size is None else _constant(size))
    n, sizes, durs = (np.stack([np.asarray(getattr(s, f)) for s in sts])
                      for f in ("n", "sizes", "durs"))
    W = A_max + 4 if W is None else W
    qlen, occ, ndep, dropped, trunc = bfjs_pallas(
        n, sizes, durs, L=L, K=K, Qcap=Qcap, A_max=A_max, work_steps=W,
        window=window, interpret=True)
    before = bfjs_kernel.launches.count
    port = result_to_numpy(bfjs_simulate(
        streams_from_numpy(n, sizes, durs, device="cpu"), L=L, K=K,
        Qcap=Qcap, A_max=A_max, work_steps=W, window=window))
    assert bfjs_kernel.launches.count == before  # CPU: plain version
    np.testing.assert_array_equal(port.queue_len, np.asarray(qlen))
    np.testing.assert_array_equal(port.departed,
                                  np.cumsum(np.asarray(ndep), axis=1))
    np.testing.assert_array_equal(port.dropped, np.asarray(dropped))
    np.testing.assert_array_equal(port.truncated, np.asarray(trunc))
    np.testing.assert_allclose(port.occupancy, np.asarray(occ), rtol=1e-6)
    if Qcap == 16:
        assert port.dropped.sum() > 0
    if W == 2:
        assert port.truncated.sum() > 0


def test_window_must_divide_horizon():
    st = _to_port(_jax_streams(1, 4, 6, 6, 60))
    with pytest.raises(ValueError, match="must divide"):
        bfjs_simulate(st, L=4, K=6, Qcap=64, A_max=6, window=7)


@pytest.mark.parametrize("fault_rate", [0.0, 0.05])
def test_state_threading_matches_straight_run(fault_rate):
    """Two half-horizons with state= / return_state= equal the straight run,
    and a JAX carry converted mid-horizon continues bit-exactly."""
    L, K, Qcap, A_max, T = 4, 6, 64, 6, 120
    sts = _jax_streams(2, L, K, A_max, T, fault_rate=fault_rate)
    full = _to_port(sts)
    straight = result_to_numpy(run_bfjs_streams(full, L=L, K=K, Qcap=Qcap,
                                                A_max=A_max))
    h = T // 2
    halves = [type(full)(*(None if x is None else x[:, sl] for x in full))
              for sl in (slice(0, h), slice(h, T))]
    r1, s1 = run_bfjs_streams(halves[0], L=L, K=K, Qcap=Qcap, A_max=A_max,
                              return_state=True)
    r2 = run_bfjs_streams(halves[1], L=L, K=K, Qcap=Qcap, A_max=A_max,
                          state=s1)
    r1, r2 = result_to_numpy(r1), result_to_numpy(r2)
    np.testing.assert_array_equal(
        np.concatenate([r1.queue_len, r2.queue_len], 1), straight.queue_len)
    np.testing.assert_array_equal(
        np.concatenate([r1.departed, r2.departed + r1.departed[:, -1:]], 1),
        straight.departed)
    np.testing.assert_array_equal(
        np.concatenate([r1.occupancy, r2.occupancy], 1), straight.occupancy)
    for f in ("dropped", "truncated", "preempted", "requeued", "lost"):
        np.testing.assert_array_equal(getattr(r2, f), getattr(straight, f))

    # JAX first half -> carry -> port second half == JAX straight run
    st = sts[0]
    first = type(st)(*(None if x is None else x[:h] for x in st))
    second = type(st)(*(None if x is None else x[h:] for x in st))
    _, carry = j_run(first, L=L, K=K, Qcap=Qcap, A_max=A_max,
                     return_state=True)
    ref = j_run(st, L=L, K=K, Qcap=Qcap, A_max=A_max)
    cont = result_to_numpy(run_bfjs_streams(
        streams_from_numpy(*second, device="cpu"), L=L, K=K, Qcap=Qcap,
        A_max=A_max, state=bfjs_state_from_numpy(carry, device="cpu")))
    np.testing.assert_array_equal(cont.queue_len,
                                  np.asarray(ref.queue_len)[h:])
    for f in ("dropped", "truncated", "preempted", "requeued", "lost"):
        np.testing.assert_array_equal(getattr(cont, f),
                                      np.asarray(getattr(ref, f)))


def test_cuda_engine_gate_falls_back_loudly():
    """The kernel does not implement fault planes or state over the
    shared-memory limit: a loud warning and the scan engine, or an error
    under strict=True."""
    sts = _jax_streams(1, 4, 6, 6, 60, fault_rate=0.05)
    st = _to_port(sts)
    scan = result_to_numpy(run_bfjs_trace(st, L=4, K=6, Qcap=64, A_max=6))
    with pytest.warns(GracefulDegradationWarning, match="fault-plane"):
        got = result_to_numpy(run_bfjs_trace(st, L=4, K=6, Qcap=64, A_max=6,
                                             engine="cuda"))
    np.testing.assert_array_equal(got.queue_len, scan.queue_len)
    with pytest.raises(ValueError, match="strict=True"):
        run_bfjs_trace(st, L=4, K=6, Qcap=64, A_max=6, engine="cuda",
                       strict=True)
    assert bfjs_scratch_bytes(1000, 16, 4096, 48) <= SMEM_LIMIT_BYTES
    Qcap = SMEM_LIMIT_BYTES // 4
    assert bfjs_scratch_bytes(4, 6, Qcap, 6) > SMEM_LIMIT_BYTES
    clean = st._replace(up=None)
    with pytest.warns(GracefulDegradationWarning, match="shared memory"):
        run_bfjs_trace(clean, L=4, K=6, Qcap=Qcap, A_max=6, engine="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run_bfjs_trace(clean, L=4, K=6, Qcap=64, A_max=6, engine="cuda",
                       strict=True)


def test_trace_shaped_streams_rejected():
    st = _to_port(_jax_streams(1, 4, 6, 6, 20))
    narrow = st._replace(durs=st.durs[..., -6:].contiguous())
    with pytest.raises(ValueError, match="duration stream of width"):
        run_bfjs_streams(narrow, L=4, K=6, Qcap=64, A_max=6)
