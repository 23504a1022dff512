"""The port's streaming runtime (core/engine/streaming.py) against the JAX
package (tests/test_streaming.py for ``repro_torch``).

The contract: ``stream_policy`` over any chunking of finite streams equals
the one-shot run bit for bit — here held against JAX's one-shot
``run_policy_streams(engine="scan")`` for every policy, faulted and not,
at chunk sizes {1, 7, 60, T}.  The trace re-bucketing equals JAX's window
for window; ``trajectory="tail"``, an unbounded generator stopped,
checkpointed and resumed, a shape change, and the engine gate are pinned
as in JAX: ``"reference"`` is rejected, and so is ``"cuda"``, which JAX
serves with its scan engine and the port never does."""
import os
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import load_trace_csv as j_load_trace  # noqa: E402
from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro.core.engine import streams_from_trace as j_from_trace  # noqa
from repro.core.engine.streaming import \
    stream_chunks_from_trace as j_chunks_from_trace  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core import Trace, load_trace_csv  # noqa: E402
from repro_torch.core.engine import (ensemble_streams,  # noqa: E402
                                     iter_stream_chunks, make_streams,
                                     run_policy_streams,
                                     stream_chunks_from_trace, stream_policy)
from repro_torch.kernels.bfjs import bfjs as bfjs_kernel  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")
T = 120
POLICIES = ("bfjs", "vqs", "vqs-bf", "bfjs-mr")
#: trajectory fields compared bit for bit (the backpressure counters are
#: timing measurements, excluded by contract)
_TRAJ = ("queue_len", "occupancy", "departed", "dropped", "truncated",
         "preempted", "requeued", "lost")
_CFG = dict(L=4, K=5, Qcap=48)


def assert_bitmatch(a, b, ctx="", occ_rtol=0.0):
    """Every trajectory field equal; ``occ_rtol`` is for bfjs against JAX,
    whose occupancy the port sums in another order (rtol 1e-6, as
    tests/test_torch_bfjs.py holds it)."""
    a, b = result_to_numpy(a), result_to_numpy(b)
    for f in _TRAJ:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (ctx, f)
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, (ctx, f)
            if f == "occupancy" and occ_rtol:
                np.testing.assert_allclose(x, y, rtol=occ_rtol,
                                           err_msg=f"{ctx}: {f}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: {f}")


def _jax_case(policy, faulted):
    key = jax.random.PRNGKey(3)
    fault = dict(fault_rate=0.03, repair_rate=0.3) if faulted else {}
    if policy == "bfjs-mr":
        streams = j_make_streams(
            key, 0.7, 0.3, lambda k, n: jax.random.uniform(
                k, (n, 2), minval=0.1, maxval=0.5), L=4, K=3, A_max=4,
            horizon=T, num_resources=2, **fault)
    else:
        streams = j_make_streams(
            key, 0.7, 0.3, lambda k, n: jax.random.uniform(
                k, (n,), minval=0.1, maxval=0.6), L=4, K=3, A_max=4,
            horizon=T, **fault)
    cfg = dict(L=4, K=3, Qcap=32, A_max=4)
    if policy in ("vqs", "vqs-bf"):
        cfg["J"] = 3
    return streams, cfg


def _port(streams):
    return streams_from_numpy(streams.n, streams.sizes, streams.durs,
                              streams.up, device="cpu")


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_stream_policy_equals_jax_one_shot(policy, faulted):
    streams, cfg = _jax_case(policy, faulted)
    one = j_rps(streams, policy=policy, engine="scan", **cfg)
    if faulted:
        assert int(one.preempted) > 0
    pst = _port(streams)
    for chunk in (1, 7, 60, T):
        res = stream_policy(iter_stream_chunks(pst, chunk), policy=policy,
                            device="cpu", **cfg)
        assert_bitmatch(res, one, f"{policy}/faulted={faulted}/{chunk}",
                        occ_rtol=1e-6 if policy == "bfjs" else 0.0)
        assert isinstance(res.chunks_behind, int) and res.chunks_behind >= 0
        assert res.host_stall_us >= 0.0
        assert res.retries is None and res.rollbacks is None


def _row_chunks(trace, rows, cls):
    for lo in range(0, len(trace.arrival_slots), rows):
        sl = slice(lo, lo + rows)
        yield cls(trace.arrival_slots[sl], trace.cpu[sl], trace.mem[sl],
                  trace.durations[sl])


def test_trace_windows_and_replay_equal_jax():
    """Row-chunked traces re-bucket into the JAX package's slot windows
    (empty windows included), and streaming them through vqs (collapsed)
    and bfjs-mr (cpu, mem) equals JAX's one-shot trace replay."""
    from repro.core import Trace as JTrace
    trace = load_trace_csv(FIXTURE, slot_seconds=10.0)
    j_trace = j_load_trace(FIXTURE, slot_seconds=10.0)
    A_max = int(np.bincount(trace.arrival_slots).max())
    for collapse in (True, False):
        for rows, chunk_slots in [(3, 5), (10, 1), (50, 11), (7, 64)]:
            got = list(stream_chunks_from_trace(
                _row_chunks(trace, rows, Trace), chunk_slots=chunk_slots,
                A_max=A_max, collapse=collapse))
            want = list(j_chunks_from_trace(
                _row_chunks(j_trace, rows, JTrace), chunk_slots=chunk_slots,
                A_max=A_max, collapse=collapse))
            assert len(got) == len(want), (collapse, rows, chunk_slots)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.n.device.type == "cpu" and g.up is None
                for f in ("n", "sizes", "durs"):
                    a, b = getattr(g, f).numpy(), np.asarray(getattr(w, f))
                    assert a.dtype == b.dtype, f
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"{collapse}/{rows}/{chunk_slots}/"
                                      f"window {i}/{f}")
    for policy, collapse, extra in (("vqs", True, {"J": 3}),
                                    ("bfjs-mr", False, {})):
        cfg = dict(_CFG, A_max=A_max, **extra)
        one = j_rps(j_from_trace(j_trace, collapse=collapse, A_max=A_max),
                    policy=policy, engine="scan", **cfg)
        res = stream_policy(stream_chunks_from_trace(
            _row_chunks(trace, 10, Trace), chunk_slots=16, A_max=A_max,
            collapse=collapse), policy=policy, device="cpu", **cfg)
        assert_bitmatch(res, one, f"trace {policy}")
    with pytest.raises(ValueError, match="num_resources"):
        stream_chunks_from_trace(iter([]), chunk_slots=4, A_max=2,
                                 num_resources=2)
    with pytest.raises(ValueError, match="chunk_slots"):
        stream_chunks_from_trace(iter([]), chunk_slots=0, A_max=2)


def _torch_streams(horizon=40, seed=7, fault_rate=0.0):
    gen = torch.Generator().manual_seed(seed)
    return make_streams(
        gen, 1.3, 0.08,
        lambda g, n, device: torch.rand(n, generator=g, device=device)
        * 0.6 + 0.1, L=4, K=5, A_max=4, horizon=horizon, device="cpu",
        fault_rate=fault_rate, repair_rate=0.3)


def test_unbounded_generator_stop_checkpoint_resume_and_tail(tmp_path):
    """An endless chunk generator: stop after N chunks, round-trip the
    carried state through checkpoint_dir=, resume for N more — equal to a
    straight 2N-chunk run.  trajectory="tail" keeps only the newest
    chunk's planes with whole-run counters."""
    CHUNK_T, N = 8, 5
    cfg = dict(_CFG, A_max=4)

    def chunks_forever():
        base = _torch_streams(horizon=CHUNK_T * (2 * N + 3),
                              fault_rate=0.05)
        yield from iter_stream_chunks(base, CHUNK_T)
        seed = 100
        while True:  # fresh synthetic chunks forever, the same each pass
            seed += 1
            yield _torch_streams(horizon=CHUNK_T, seed=seed,
                                 fault_rate=0.05)

    ck = str(tmp_path / "stream_ck")
    first = stream_policy(chunks_forever(), policy="bfjs",
                          checkpoint_dir=ck, stop_after_chunks=N,
                          device="cpu", **cfg)
    assert first.queue_len.shape == (N * CHUNK_T,)
    resumed = stream_policy(chunks_forever(), policy="bfjs",
                            checkpoint_dir=ck, resume=True,
                            stop_after_chunks=N, device="cpu", **cfg)
    straight = stream_policy(chunks_forever(), policy="bfjs",
                             stop_after_chunks=2 * N, device="cpu", **cfg)
    assert straight.queue_len.shape == (2 * N * CHUNK_T,)
    assert int(straight.preempted) > 0
    assert_bitmatch(straight, resumed, "resume-vs-straight")
    tail = stream_policy(chunks_forever(), policy="bfjs",
                         stop_after_chunks=22, trajectory="tail",
                         device="cpu", **cfg)
    straight22 = stream_policy(chunks_forever(), policy="bfjs",
                               stop_after_chunks=22, device="cpu", **cfg)
    assert tail.queue_len.shape == (CHUNK_T,)
    for f in ("queue_len", "occupancy", "departed"):
        np.testing.assert_array_equal(
            getattr(tail, f).numpy(), getattr(straight22, f)[-CHUNK_T:]
            .numpy(), err_msg=f)
    for f in ("dropped", "truncated", "preempted", "requeued", "lost"):
        assert int(getattr(tail, f)) == int(getattr(straight22, f)), f


def test_resume_rejects_a_different_stream(tmp_path):
    cfg = dict(_CFG, A_max=4)
    ck = str(tmp_path / "ck")
    stream_policy(iter_stream_chunks(_torch_streams(), 10), policy="bfjs",
                  checkpoint_dir=ck, stop_after_chunks=2, device="cpu",
                  **cfg)
    with pytest.raises(ValueError, match="different stream"):
        stream_policy(iter_stream_chunks(_torch_streams(seed=99), 10),
                      policy="bfjs", checkpoint_dir=ck, resume=True,
                      device="cpu", **cfg)
    with pytest.raises(ValueError, match="different stream"):
        stream_policy(iter_stream_chunks(_torch_streams(), 10),
                      policy="bfjs", checkpoint_dir=ck, resume=True,
                      trajectory="tail", device="cpu", **cfg)
    with pytest.raises(ValueError, match="resume=True needs"):
        stream_policy(iter_stream_chunks(_torch_streams(), 10),
                      policy="bfjs", resume=True, device="cpu", **cfg)


def test_double_buffer_determinism_slow_vs_fast_host():
    """Results are independent of host prep timing; only the backpressure
    counters may differ.  Host chunks given as numpy planes of other
    dtypes are staged with the engines' dtypes."""
    streams = _torch_streams()
    cfg = dict(_CFG, A_max=4)

    def slow_numpy_chunks():
        for piece in iter_stream_chunks(streams, 8):
            time.sleep(0.01)
            yield piece._replace(n=piece.n.numpy().astype(np.int64),
                                 sizes=piece.sizes.double().numpy())

    fast = stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                         device="cpu", **cfg)
    slow = stream_policy(slow_numpy_chunks(), policy="bfjs", device="cpu",
                         **cfg)
    assert_bitmatch(fast, slow, "slow-vs-fast host")
    assert_bitmatch(fast, run_policy_streams(streams, policy="bfjs", **cfg),
                    "stream vs one-shot")
    one = run_policy_streams(streams, policy="bfjs", **cfg)
    assert one.chunks_behind is None and one.host_stall_us is None


def test_streaming_error_paths():
    streams = _torch_streams()
    cfg = dict(_CFG, A_max=4)
    with pytest.raises(ValueError, match="empty"):
        stream_policy(iter([]), policy="bfjs", device="cpu", **cfg)
    with pytest.raises(ValueError, match="trajectory"):
        stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                      trajectory="middle", device="cpu", **cfg)
    with pytest.raises(ValueError, match="no stateful scan engine"):
        stream_policy(iter_stream_chunks(streams, 8), policy="nope",
                      device="cpu", **cfg)
    with pytest.raises(ValueError, match="unknown engine"):
        stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                      engine="pallas", device="cpu", **cfg)
    with pytest.raises(ValueError, match="host-side state"):
        stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                      engine="reference", device="cpu", **cfg)
    with pytest.raises(ValueError, match="chunk must be positive"):
        next(iter_stream_chunks(streams, 0))
    # chunks must keep one shape for the life of the stream
    wider = streams._replace(
        sizes=torch.cat([streams.sizes, streams.sizes[:, :1] * 0], dim=1),
        durs=torch.cat([streams.durs, streams.durs[:, :1]], dim=1))

    def mixed():
        yield next(iter_stream_chunks(streams, 8))
        yield next(iter_stream_chunks(wider, 8))

    with pytest.raises(ValueError, match="changed shape mid-stream"):
        stream_policy(mixed(), policy="bfjs", device="cpu", **cfg)


def test_cuda_request_is_refused(monkeypatch):
    """engine="cuda" cannot thread a carry across chunks: it raises a
    ValueError naming the carry, as the chunked run_policy_streams does,
    and launches no kernel; nothing runs the scan engine in its place.
    device=None means the card."""
    streams = _torch_streams()
    cfg = dict(_CFG, A_max=4)
    bfjs_kernel.launches.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="carry a streaming run"):
            stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                          engine="cuda", device="cpu", **cfg)
    with pytest.raises(ValueError, match='engine="scan"'):
        run_policy_streams(streams, policy="bfjs", engine="cuda", chunk=8,
                           device="cpu", **cfg)
    assert bfjs_kernel.launches.count == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        stream_policy(iter_stream_chunks(streams, 8), policy="bfjs", **cfg)


def test_ensemble_chunks_stream_batched():
    """Ensemble-batched chunks (leading G axis) stream through the batched
    scan engine and equal the one-shot and the chunked ensemble runs."""
    streams = ensemble_streams(
        [3, 4, 5], 1.3, 0.08,
        lambda g, n, device: torch.rand(n, generator=g, device=device)
        * 0.6 + 0.1, L=4, K=5, A_max=4, horizon=24, device="cpu")
    cfg = dict(_CFG, A_max=4)
    one = run_policy_streams(streams, policy="bfjs", **cfg)
    chunked = run_policy_streams(streams, policy="bfjs", chunk=10, **cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = stream_policy(iter_stream_chunks(streams, 8), policy="bfjs",
                            device="cpu", audit=True, **cfg)
    assert res.queue_len.shape == (3, 24)
    assert_bitmatch(one, res, "ensemble stream")
    assert_bitmatch(one, chunked, "ensemble chunked")
