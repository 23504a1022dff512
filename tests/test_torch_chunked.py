"""Crash-safe chunked sweeps of the port (core/engine/chunked.py) against
the JAX package's (tests/test_checkpoint_sweeps.py for ``repro_torch``).

On JAX-made faulted streams (T = 240, L = 4) for every policy: a sweep
stopped at a boundary and resumed equals JAX's straight-through
``run_policy_streams(engine="scan")`` on every field; a checkpoint JAX's
``run_chunked`` wrote resumes in the port to the same result (one
``streams_fingerprint`` for one set of streams); any kill schedule, and a
real SIGKILL inside the checkpoint writer, resume bit-exactly; a different
sweep and bad usage are refused; ``monte_carlo_policy(chunk=)`` equals the
straight scan run."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.engine import chunked as j_chunked  # noqa: E402
from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core.engine import (BFJSState, BFJSMRState,  # noqa: E402
                                     VQSBFState, VQSState, Workload,
                                     monte_carlo_policy, run_chunked,
                                     run_policy_streams,
                                     streams_fingerprint)
from repro_torch.core.engine import chunked  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
T = 240
FAULT = dict(fault_rate=0.02, repair_rate=0.3)
POLICIES = ("bfjs", "vqs", "vqs-bf", "bfjs-mr")
STATES = {"bfjs": BFJSState, "vqs": VQSState, "vqs-bf": VQSBFState,
          "bfjs-mr": BFJSMRState}


def _scalar_sampler(key, n):
    return jax.random.uniform(key, (n,), minval=0.1, maxval=0.6)


def _vec_sampler(key, n):
    return jax.random.uniform(key, (n, 2), minval=0.1, maxval=0.5)


def _case(policy):
    """JAX streams and the engine config of tests/test_checkpoint_sweeps.py
    (vqs-bf with vqs's J): small faulted sweeps, so resume carries retry
    planes, fault counters and ``up_last`` across boundaries."""
    key = jax.random.PRNGKey(3)
    if policy == "bfjs-mr":
        streams = j_make_streams(key, 0.6, 0.5, _vec_sampler, L=4, K=3,
                                 A_max=4, horizon=T, num_resources=2,
                                 **FAULT)
    else:
        streams = j_make_streams(key, 0.6, 0.5, _scalar_sampler, L=4, K=3,
                                 A_max=4, horizon=T, **FAULT)
    cfg = dict(L=4, K=3, Qcap=32, A_max=4)
    if policy in ("vqs", "vqs-bf"):
        cfg["J"] = 4
    return streams, cfg


def _port(streams):
    return streams_from_numpy(streams.n, streams.sizes, streams.durs,
                              streams.up, device="cpu")


@pytest.fixture(scope="module")
def cases():
    """policy -> (JAX streams, port streams, config, JAX straight run)."""
    out = {}
    for policy in POLICIES:
        streams, cfg = _case(policy)
        full = j_rps(streams, policy=policy, engine="scan", **cfg)
        out[policy] = (streams, _port(streams), cfg, full)
    return out


def _assert_equal_jax(res, full, msg, policy):
    """Every PolicyResult field, dtype and shape included, equal — but for
    bfjs's occupancy, which the port sums in another order (rtol 1e-6, as
    tests/test_torch_bfjs.py holds it)."""
    got = result_to_numpy(res)
    for f in full._fields:
        want = getattr(full, f)
        if want is None:
            assert getattr(got, f) is None, (msg, f)
            continue
        a, b = np.asarray(getattr(got, f)), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype, (msg, f)
        if f == "occupancy" and policy == "bfjs":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=msg)
        else:
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"{msg}: field {f!r}")


@pytest.mark.parametrize("policy", POLICIES)
def test_stop_then_resume_equals_jax_straight_through(cases, policy,
                                                      tmp_path):
    streams, pst, cfg, full = cases[policy]
    d = str(tmp_path)
    part = run_policy_streams(pst, policy=policy, engine="scan",
                              checkpoint_dir=d, chunk=60,
                              stop_after_chunks=2, **cfg)
    assert part.queue_len.shape[0] == 120   # 2 of 4 chunks ran
    assert ckpt.list_steps(d) == [1, 2]
    assert int(full.preempted) > 0          # resume crossed fault state
    res = run_policy_streams(pst, policy=policy, engine="scan",
                             checkpoint_dir=d, chunk=60, resume=True, **cfg)
    _assert_equal_jax(res, full, f"{policy}: resumed != JAX straight",
                      policy)
    # resuming a FINISHED sweep returns the stored result, runs nothing
    res2 = run_policy_streams(pst, policy=policy, engine="scan",
                              checkpoint_dir=d, chunk=60, resume=True, **cfg)
    _assert_equal_jax(res2, full, f"{policy}: finished-resume", policy)
    # the boundary holds the policy's whole carry, restored by field
    state, partial = chunked._load_step(d, 4, policy, torch.device("cpu"))
    assert type(state) is STATES[policy]
    assert state.up_last.dtype == torch.bool
    _assert_equal_jax(partial, full, f"{policy}: stored partial", policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_jax_checkpoint_resumes_in_the_port(cases, policy, tmp_path):
    """JAX's ``run_chunked`` stops after two chunks; the port resumes its
    directory and ends at JAX's straight-through result."""
    streams, pst, cfg, full = cases[policy]
    d = str(tmp_path)
    j_rps(streams, policy=policy, engine="scan", checkpoint_dir=d,
          chunk=60, stop_after_chunks=2, **cfg)
    assert streams_fingerprint(pst) == j_chunked.streams_fingerprint(streams)
    extra = ckpt.read_manifest(d, 2)["extra"]
    assert extra["streams_sha256"] == streams_fingerprint(pst)
    res = run_policy_streams(pst, policy=policy, engine="scan",
                             checkpoint_dir=d, chunk=60, resume=True, **cfg)
    _assert_equal_jax(res, full, f"{policy}: JAX checkpoint -> port",
                      policy)
    assert ckpt.list_steps(d) == [1, 2, 3, 4]


def test_fingerprints_agree_on_ensemble_and_lifted_streams(cases):
    """One digest for one set of streams in both packages: batched planes,
    a fault plane, and the bfjs-mr size lift."""
    from repro.core.engine.bfjs_mr import _lift_sizes as j_lift
    from repro_torch.core.engine.bfjs_mr import _lift_sizes
    streams, pst, _, _ = cases["bfjs"]
    batched = jax.tree.map(lambda x: np.stack([x, x]), streams)
    p_batched = pst._replace(**{f: torch.stack([getattr(pst, f)] * 2)
                                for f in ("n", "sizes", "durs", "up")})
    assert streams_fingerprint(p_batched) == \
        j_chunked.streams_fingerprint(batched)
    bare = streams._replace(up=None)
    assert streams_fingerprint(_lift_sizes(pst._replace(up=None))) == \
        j_chunked.streams_fingerprint(j_lift(bare))
    assert streams_fingerprint(pst) != \
        streams_fingerprint(pst._replace(up=None))


@pytest.fixture(scope="module")
def bfjs_straight(cases):
    _, pst, cfg, _ = cases["bfjs"]
    return run_policy_streams(pst, policy="bfjs", engine="scan", **cfg)


def test_any_kill_schedule_resumes_bitexact(cases, bfjs_straight,
                                            tmp_path_factory):
    """Property: for ANY chunk length (ragged tail included) and ANY
    schedule of interruptions, chained resumed runs reproduce the
    uninterrupted trajectory bit for bit."""
    _, pst, cfg, full = cases["bfjs"]
    _assert_equal_jax(bfjs_straight, full, "bfjs straight", "bfjs")

    @settings(max_examples=10, deadline=None, derandomize=True)
    @given(chunk=st.sampled_from([30, 50, 70, 80]),
           kills=st.lists(st.integers(min_value=1, max_value=3),
                          min_size=1, max_size=3))
    def prop(chunk, kills):
        d = str(tmp_path_factory.mktemp("kills"))
        run_policy_streams(pst, policy="bfjs", checkpoint_dir=d,
                           chunk=chunk, stop_after_chunks=kills[0], **cfg)
        for k in kills[1:]:
            run_policy_streams(pst, policy="bfjs", checkpoint_dir=d,
                               chunk=chunk, resume=True,
                               stop_after_chunks=k, **cfg)
        res = run_policy_streams(pst, policy="bfjs", checkpoint_dir=d,
                                 chunk=chunk, resume=True, **cfg)
        _assert_equal_jax(res, full, f"chunk={chunk} kills={kills}",
                          "bfjs")

    prop()


_CHILD = """
import os, signal, sys
import numpy as np
import repro_torch.core.engine.chunked as chunked
from repro_torch.convert import streams_from_numpy
from repro_torch.core.engine import run_policy_streams

planes = np.load(sys.argv[2])
streams = streams_from_numpy(planes["n"], planes["sizes"], planes["durs"],
                             planes["up"], device="cpu")
_real, _calls = chunked._save_step, 0

def _killing_save(*args, **kwargs):
    global _calls
    _real(*args, **kwargs)
    _calls += 1
    if _calls >= 2:
        os.kill(os.getpid(), signal.SIGKILL)

chunked._save_step = _killing_save
run_policy_streams(streams, policy="bfjs", engine="scan",
                   checkpoint_dir=sys.argv[1], chunk=60, L=4, K=3, Qcap=32,
                   A_max=4)
sys.exit("survived past the kill point")
"""


def test_sigkill_mid_sweep_then_resume(cases, tmp_path):
    """A real SIGKILL inside the checkpoint writer (no cleanup, no
    atexit), in a process that imports only the port: the surviving
    checkpoints resume to JAX's straight-through trajectory."""
    streams, pst, cfg, full = cases["bfjs"]
    planes = tmp_path / "streams.npz"
    np.savez(planes, **{f: np.asarray(getattr(streams, f))
                        for f in ("n", "sizes", "durs", "up")})
    d = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, d, str(planes)],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-2000:])
    assert ckpt.latest_step(d) == 2          # died right after save #2
    res = run_policy_streams(pst, policy="bfjs", checkpoint_dir=d,
                             chunk=60, resume=True, **cfg)
    _assert_equal_jax(res, full, "post-SIGKILL resume", "bfjs")


def test_resume_refuses_a_different_sweep(cases, tmp_path):
    _, pst, cfg, _ = cases["bfjs"]
    d = str(tmp_path)
    run_policy_streams(pst, policy="bfjs", checkpoint_dir=d, chunk=60,
                       stop_after_chunks=1, **cfg)
    with pytest.raises(ValueError, match="different sweep"):
        run_policy_streams(pst, policy="bfjs", checkpoint_dir=d, chunk=80,
                           resume=True, **cfg)
    other = pst._replace(sizes=pst.sizes * 0.5)
    assert streams_fingerprint(other) != streams_fingerprint(pst)
    with pytest.raises(ValueError, match="different sweep"):
        run_policy_streams(other, policy="bfjs", checkpoint_dir=d,
                           chunk=60, resume=True, **cfg)
    with pytest.raises(ValueError, match="different sweep"):
        run_policy_streams(pst._replace(up=None), policy="bfjs",
                           checkpoint_dir=d, chunk=60, resume=True, **cfg)
    with pytest.raises(ValueError, match="different sweep"):
        run_policy_streams(pst, policy="bfjs", checkpoint_dir=d, chunk=60,
                           resume=True, work_steps=3, **cfg)
    # the manifest pins no device: device=/strict=/window= leave it as is
    res = run_chunked(pst, policy="bfjs", chunk=60, checkpoint_dir=d,
                      resume=True, stop_after_chunks=1, device="cuda",
                      strict=True, window=60, **cfg)
    assert res.queue_len.shape == (120,)
    assert "device" not in ckpt.read_manifest(d, 2)["extra"]["config"]


def test_chunked_rejects_bad_usage(cases, tmp_path):
    _, pst, cfg, _ = cases["bfjs"]
    for engine in ("cuda", "reference"):
        with pytest.raises(ValueError, match='engine="scan"'):
            run_policy_streams(pst, policy="bfjs", engine=engine, chunk=60,
                               **cfg)
    with pytest.raises(ValueError, match="need chunk="):
        run_policy_streams(pst, policy="bfjs",
                           checkpoint_dir=str(tmp_path), **cfg)
    with pytest.raises(ValueError, match="need chunk="):
        run_policy_streams(pst, policy="bfjs", resume=True, **cfg)
    with pytest.raises(ValueError, match="chunk must be positive"):
        run_chunked(pst, policy="bfjs", chunk=0, **cfg)
    with pytest.raises(ValueError, match="resume=True needs"):
        run_chunked(pst, policy="bfjs", chunk=60, resume=True, **cfg)
    with pytest.raises(ValueError, match="no stateful scan engine"):
        run_chunked(pst, policy="nope", chunk=60, **cfg)
    with pytest.raises(ValueError, match="nothing to run"):
        run_chunked(pst, policy="bfjs", chunk=60, stop_after_chunks=0,
                    **cfg)
    with pytest.raises(ValueError, match='engine="scan"'):
        monte_carlo_policy(Workload(lam=1.0, mu=0.1, sampler=_torch_sampler),
                           seeds=[0], engine="cuda", chunk=10, device="cpu",
                           L=4, K=6, Qcap=16, A_max=4, horizon=20)


def _torch_sampler(gen, n, device):
    return torch.rand(n, generator=gen, device=device) * 0.45 + 0.05


def _torch_vec_sampler(gen, n, device):
    return torch.rand((n, 2), generator=gen, device=device) * 0.45 + 0.05


@pytest.mark.parametrize("policy", POLICIES)
def test_monte_carlo_chunked_equals_straight(policy, tmp_path):
    """``monte_carlo_policy(chunk=)`` — a resumed faulted ensemble sweep
    — equals the straight scan ensemble on every field."""
    mr = policy == "bfjs-mr"
    wl = Workload(lam=1.2, mu=0.05,
                  sampler=_torch_vec_sampler if mr else _torch_sampler,
                  num_resources=2 if mr else 1,
                  capacity=(1.0, 0.75) if mr else 1.0)
    cfg = dict(L=4, K=6, Qcap=48, A_max=5, horizon=90, fault_rate=0.03,
               repair_rate=0.3, device="cpu")
    if policy in ("vqs", "vqs-bf"):
        cfg["J"] = 3
    straight = monte_carlo_policy(wl, seeds=[4, 7, 9], policy=policy,
                                  engine="scan", **cfg)
    d = str(tmp_path)
    monte_carlo_policy(wl, seeds=[4, 7, 9], policy=policy, chunk=25,
                       checkpoint_dir=d, stop_after_chunks=2, **cfg)
    res = monte_carlo_policy(wl, seeds=[4, 7, 9], policy=policy, chunk=25,
                             checkpoint_dir=d, resume=True, **cfg)
    assert res.queue_len.shape == (3, 90)
    assert int(straight.preempted.sum()) > 0
    for f, a, b in zip(res._fields, result_to_numpy(res),
                       result_to_numpy(straight)):
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f"{policy} {f}")
