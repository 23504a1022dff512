"""Supervised streaming of the port (core/engine/supervisor.py and the
supervised paths of streaming.py) against the JAX package
(tests/test_supervisor.py for ``repro_torch``): the backoff schedule equal
to JAX's for one seed, retry / warning / non-retryable cases, watchdog
timeouts, dead plain generators, quarantine with its manifest and counts,
rollback over garbled and truncated checkpoints, the invariant auditor
(margins and messages equal to JAX's), and SIGKILL, corruption, then a
supervised resume.

The contract: transient-fault recovery is BIT-EXACT — a supervised run
through flaky ingestion, staging and checkpoint paths equals the
unperturbed run, here JAX's one-shot ``run_policy_streams`` on the same
streams; only a QUARANTINED chunk changes the trajectory, and then exactly
by that chunk's absence."""
import json
import os
import random
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro.core.engine import supervisor as j_sup  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core import trace as trace_mod  # noqa: E402
from repro_torch.core.engine import (CheckpointRollbackWarning,  # noqa
                                     InvariantViolation, RetryPolicy,
                                     Supervisor, SupervisorError,
                                     SupervisorTimeout, SupervisorWarning,
                                     audit_result, iter_stream_chunks,
                                     run_policy_streams,
                                     stream_chunks_from_trace, stream_policy,
                                     streams_from_trace)

SRC = Path(__file__).resolve().parents[1] / "src"
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "google_like_50.csv")
_TRAJ = ("queue_len", "occupancy", "departed", "dropped", "truncated",
         "preempted", "requeued", "lost")
_CFG = dict(L=4, K=5, Qcap=48)
CFG = dict(_CFG, A_max=4)


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


def assert_matches_jax(res, ref, policy, ctx=""):
    assert_bitmatch(res, ref, ctx, occ_rtol=1e-6 if policy == "bfjs"
                    else 0.0)


def _jax_streams(horizon=40, fault_rate=0.0):
    return j_make_streams(
        jax.random.PRNGKey(7), lam=1.3, mu=0.08,
        sampler=lambda k, s: jax.random.uniform(k, s, minval=0.1,
                                                maxval=0.7),
        L=4, K=5, A_max=4, horizon=horizon,
        **({"fault_rate": fault_rate, "repair_rate": 0.3}
           if fault_rate else {}))


def _port(streams):
    return streams_from_numpy(streams.n, streams.sizes, streams.durs,
                              streams.up, device="cpu")


@pytest.fixture(scope="module")
def synth():
    """The JAX package's synthetic streams and its one-shot runs of them
    (bfjs and vqs), and the same streams in the port."""
    streams = _jax_streams()
    refs = {"bfjs": j_rps(streams, policy="bfjs", engine="scan", **CFG),
            "vqs": j_rps(streams, policy="vqs", engine="scan", J=3, **CFG)}
    return _port(streams), refs


def _sup(**kw):
    kw.setdefault("sleep", lambda s: None)  # no wall-clock in tests
    return Supervisor(**kw)


def _run(chunks, **kw):
    kw = {**CFG, "policy": "bfjs", "device": "cpu", **kw}
    return stream_policy(chunks, **kw)


class ChunkSource:
    """Index-addressed, idempotent-on-failure chunk source with the
    optional ``skip()`` quarantine protocol — the supervised-source
    contract ``ResumableTraceReader`` implements for CSV files."""

    def __init__(self, chunks, poison=(), transient=None):
        self.chunks = list(chunks)
        self.i = 0
        self.poison = set(poison)                # fail forever
        self.transient = dict(transient or {})   # fail n times, then work

    def __iter__(self):
        return self

    def skip(self):
        self.i += 1

    def __next__(self):
        if self.i in self.poison:
            raise OSError(f"poison chunk {self.i}")
        n = self.transient.get(self.i, 0)
        if n:
            self.transient[self.i] = n - 1
            raise OSError(f"transient fault on chunk {self.i}")
        if self.i >= len(self.chunks):
            raise StopIteration
        out = self.chunks[self.i]
        self.i += 1
        return out


# ---------------------------------------------------------------------------
# RetryPolicy / Supervisor.call mechanics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_schedule_equals_jax_and_is_capped(seed):
    kw = dict(base_delay=0.1, max_delay=0.5, jitter=0.5, seed=seed)
    p, jp = RetryPolicy(**kw), j_sup.RetryPolicy(**kw)
    rng, jrng = random.Random(seed), random.Random(seed)
    delays = [p.delay(k, rng) for k in range(1, 9)]
    assert delays == [jp.delay(k, jrng) for k in range(1, 9)]
    for k, d in enumerate(delays, start=1):
        base = min(0.5, 0.1 * 2.0 ** (k - 1))
        assert base * 0.5 <= d <= base  # jitter shrinks, never grows
    # the supervisor draws its schedule from the policy's seed
    sup, jsup = Supervisor(retry=p), j_sup.Supervisor(retry=jp)
    assert [p.delay(k, sup._rng) for k in (1, 2, 3)] == \
        [jp.delay(k, jsup._rng) for k in (1, 2, 3)]


def test_call_retries_then_reraises_and_counts():
    slept = []
    sup = _sup(retry=RetryPolicy(max_retries=3), sleep=slept.append)
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("always")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        with pytest.raises(OSError):
            sup.call("ingest", flaky)
    assert len(calls) == 4          # 1 attempt + 3 retries
    assert sup.retries == 3 and len(slept) == 3
    jrng = random.Random(0)
    assert slept == [RetryPolicy().delay(k, jrng) for k in (1, 2, 3)]
    assert [e[0] for e in sup.report()["events"]] == ["retry"] * 4


def test_call_does_not_retry_non_retryable():
    sup = _sup(retry=RetryPolicy(max_retries=3))
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        sup.call("stage", broken)
    assert len(calls) == 1 and sup.retries == 0


def test_call_warns_loudly_per_retry():
    attempts = [2]
    sup = _sup(retry=RetryPolicy(max_retries=5))

    def flaky():
        if attempts[0]:
            attempts[0] -= 1
            raise OSError("transient")
        return "ok"

    with pytest.warns(SupervisorWarning, match="chunk 7.*retry 1/5"):
        assert sup.call("ingest", flaky, chunk_index=7) == "ok"
    assert sup.retries == 2


def test_watchdog_times_out_with_typed_escalation():
    sup = Supervisor(compute_timeout=0.05)
    with pytest.raises(SupervisorTimeout) as e:
        sup.watch("device compute", lambda: time.sleep(1.0), 0.05,
                  chunk_index=3)
    assert e.value.phase == "device compute"
    assert e.value.chunk_index == 3
    assert isinstance(e.value, SupervisorError)
    assert sup.timeouts == 1
    assert sup.watch("stage", lambda: 5, 1.0) == 5
    with pytest.raises(KeyError):
        sup.watch("stage", lambda: {}["x"], 1.0)


def test_watchdog_timeout_is_not_retried():
    sup = _sup(retry=RetryPolicy(max_retries=5))
    with pytest.raises(SupervisorTimeout):
        sup.call("stage", lambda: time.sleep(1.0), timeout=0.05)
    assert sup.retries == 0


# ---------------------------------------------------------------------------
# Supervised streaming: transient recovery is bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,extra", [("bfjs", {}), ("vqs", {"J": 3})])
def test_transient_ingestion_faults_recover_bit_exact(synth, policy, extra):
    pst, refs = synth
    chunks = list(iter_stream_chunks(pst, 7))
    sup = _sup(retry=RetryPolicy(max_retries=3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        res = _run(ChunkSource(chunks, transient={1: 2, 3: 1}),
                   policy=policy, supervisor=sup, audit=True, **extra)
    assert_matches_jax(res, refs[policy], policy, f"{policy}-transient")
    assert res.retries == 3
    assert res.quarantined == 0 and res.rollbacks == 0


def test_unsupervised_result_has_no_supervision_counters(synth):
    res = _run(iter_stream_chunks(synth[0], 7))
    assert res.retries is None
    assert res.quarantined is None
    assert res.rollbacks is None


def test_dead_plain_generator_is_detected_not_truncated(synth):
    chunks = list(iter_stream_chunks(synth[0], 7))

    def dying():
        for i, c in enumerate(chunks):
            if i == 2:
                raise OSError("die once")
            yield c

    sup = _sup(retry=RetryPolicy(max_retries=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        with pytest.raises(SupervisorError, match="ResumableTraceReader"):
            _run(dying(), supervisor=sup)


# ---------------------------------------------------------------------------
# Poison-chunk quarantine
# ---------------------------------------------------------------------------

def test_quarantine_skips_with_manifest_and_exact_accounting(synth,
                                                             tmp_path):
    chunks = list(iter_stream_chunks(synth[0], 7))
    # ground truth: the same stream with the poison chunk simply absent
    ref = _run(iter(chunks[:2] + chunks[3:]))
    qdir = tmp_path / "quarantine"
    sup = _sup(retry=RetryPolicy(max_retries=2), quarantine_dir=str(qdir))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        res = _run(ChunkSource(chunks, poison={2}), supervisor=sup)
    assert res.quarantined == 1
    assert res.retries == 2           # the poison exhausted its retries
    assert_bitmatch(ref, res, "poison-minus-chunk")
    man = json.loads((qdir / "chunk_00000002" / "manifest.json")
                     .read_text())
    assert man["chunk_index"] == 2
    assert man["error_type"] == "OSError"
    assert man["policy"] == "bfjs"
    assert man["has_planes"] is False
    assert "poison" in man["error"] and "OSError" in man["traceback"]
    assert man["config"]["L"] == "4"
    assert sup.report()["quarantined"] == 1


def test_quarantine_refused_without_a_quarantine_dir(synth):
    chunks = list(iter_stream_chunks(synth[0], 7))
    sup = _sup(retry=RetryPolicy(max_retries=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        with pytest.raises(SupervisorError, match="quarantine_dir"):
            _run(ChunkSource(chunks, poison={2}), supervisor=sup)


def test_consecutive_quarantines_abort_a_broken_source(synth, tmp_path):
    chunks = list(iter_stream_chunks(synth[0], 7))
    sup = _sup(retry=RetryPolicy(max_retries=0),
               quarantine_dir=str(tmp_path / "q"),
               max_consecutive_quarantines=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        with pytest.raises(SupervisorError, match="consecutive"):
            _run(ChunkSource(chunks, poison={1, 2, 3}), supervisor=sup)
    assert sup.quarantined == 3


def test_staging_poison_preserves_planes(synth, tmp_path):
    """A chunk that ingests but fails staging (mid-stream shape change) is
    quarantined WITH its stream planes for forensics."""
    chunks = list(iter_stream_chunks(synth[0], 7))
    bad = chunks[2]._replace(sizes=torch.cat([chunks[2].sizes] * 2, dim=1))
    ref = _run(iter(chunks[:2] + chunks[3:]))
    qdir = tmp_path / "q"
    sup = _sup(quarantine_dir=str(qdir))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        res = _run(iter(chunks[:2] + [bad] + chunks[3:]), supervisor=sup)
    assert res.quarantined == 1
    assert_bitmatch(ref, res, "staging-poison")
    man = json.loads((qdir / "chunk_00000002" / "manifest.json")
                     .read_text())
    assert man["has_planes"] is True
    assert "changed shape" in man["error"]
    saved = np.load(qdir / "chunk_00000002" / "chunk.npz")
    assert saved["sizes"].shape[1] == 8  # the corrupt width, preserved
    np.testing.assert_array_equal(saved["n"], chunks[2].n.numpy())


# ---------------------------------------------------------------------------
# Checkpoint integrity + rollback
# ---------------------------------------------------------------------------

def _corrupt(path, mode):
    if mode == "garbage":
        with open(path, "r+b") as f:
            f.seek(0)
            f.write(b"\x00garbage\x00garbage\x00")
    else:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))


@pytest.mark.parametrize("mode", ["garbage", "truncate"])
def test_rollback_resume_is_bit_exact(synth, tmp_path, mode):
    pst, refs = synth
    ck = tmp_path / "ck"
    _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck))
    steps = ckpt.list_steps(str(ck))
    assert steps == [1, 2, 3, 4, 5, 6]
    _corrupt(ck / f"step_{steps[-1]:08d}" / "arrays.npz", mode)
    # unsupervised resume surfaces the damage as a typed error
    with pytest.raises(ckpt.CheckpointCorruptError):
        _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck),
             resume=True)
    # supervised resume rolls back to the last good boundary, warns,
    # counts — and equals the unperturbed run
    sup = _sup()
    with pytest.warns(CheckpointRollbackWarning, match="corrupt"):
        res = _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck),
                   resume=True, supervisor=sup)
    assert res.rollbacks == 1
    assert_matches_jax(res, refs["bfjs"], "bfjs", f"rollback-{mode}")


def test_rollback_to_nothing_restarts_from_scratch(synth, tmp_path):
    pst, refs = synth
    ck = tmp_path / "ck"
    _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck),
         stop_after_chunks=2)
    for step in ckpt.list_steps(str(ck)):
        _corrupt(ck / f"step_{step:08d}" / "arrays.npz", "garbage")
    with pytest.warns(CheckpointRollbackWarning):
        res = _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck),
                   resume=True, supervisor=_sup())
    assert res.rollbacks == 2
    assert_matches_jax(res, refs["bfjs"], "bfjs", "rollback-all")


def test_fully_cached_supervised_resume_reports_counters(synth, tmp_path):
    """A fully-cached resume returns the checkpointed result with the
    backpressure counters reset to zero (this call pipelined nothing)
    and, under supervision, the supervision counters attached."""
    pst, refs = synth
    ck = str(tmp_path / "ck")
    _run(iter_stream_chunks(pst, 7), checkpoint_dir=ck)
    res = _run(iter_stream_chunks(pst, 7), checkpoint_dir=ck, resume=True)
    assert_matches_jax(res, refs["bfjs"], "bfjs", "cached")
    assert (res.chunks_behind, res.host_stall_us) == (0, 0.0)
    assert res.retries is None and res.quarantined is None \
        and res.rollbacks is None
    res2 = _run(iter_stream_chunks(pst, 7), checkpoint_dir=ck, resume=True,
                supervisor=_sup())
    assert (res2.chunks_behind, res2.host_stall_us) == (0, 0.0)
    assert (res2.retries, res2.quarantined, res2.rollbacks) == (0, 0, 0)


def test_supervised_checkpoint_write_retries(synth, tmp_path, monkeypatch):
    from repro_torch.core.engine import streaming as streaming_mod
    pst, refs = synth
    real = streaming_mod._save_step
    fails = {2: 2}  # step 2's save fails twice, then lands

    def flaky_save(checkpoint_dir, step, payload, extra):
        if fails.get(step, 0):
            fails[step] -= 1
            raise OSError(f"disk hiccup at step {step}")
        return real(checkpoint_dir, step, payload, extra)

    monkeypatch.setattr(streaming_mod, "_save_step", flaky_save)
    sup = _sup(retry=RetryPolicy(max_retries=3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SupervisorWarning)
        res = _run(iter_stream_chunks(pst, 7),
                   checkpoint_dir=str(tmp_path / "ck"), supervisor=sup)
    assert res.retries == 2
    assert_matches_jax(res, refs["bfjs"], "bfjs", "flaky-ckpt-write")
    assert ckpt.latest_valid_step(str(tmp_path / "ck")) == (6, [])


# ---------------------------------------------------------------------------
# Runtime invariant auditor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,extra,fault", [
    ("bfjs", {}, 0.05), ("vqs", {"J": 3}, 0.05), ("vqs-bf", {"J": 3}, 0.0),
])
def test_audit_passes_on_healthy_runs(policy, extra, fault):
    pst = _port(_jax_streams(fault_rate=fault))
    res = _run(iter_stream_chunks(pst, 7), policy=policy, audit=True,
               **extra)
    assert res.truncated is not None  # ran to completion
    assert_bitmatch(res, run_policy_streams(pst, policy=policy,
                                            audit=True, **CFG, **extra),
                    f"audited {policy}")


def test_audit_passes_on_bfjs_mr_multi_resource():
    tr = trace_mod.synthesize_google_like_trace(120, 60, seed=3)
    st = streams_from_trace(tr.arrival_slots,
                            np.stack([tr.cpu, tr.mem], 1),
                            np.minimum(tr.durations, 20), A_max=8,
                            device="cpu")
    res = stream_policy(iter_stream_chunks(st, 13), policy="bfjs-mr",
                        audit=True, L=4, K=6, Qcap=64, device="cpu")
    assert res.occupancy.shape == (int(st.n.shape[0]), 2)


@pytest.mark.parametrize("tamper,law", [
    ("occupancy", "occupancy_capacity"), ("departed", "in_flight_nonneg"),
    ("queue_len", "queue_nonneg"), ("lost", "preempted_split")])
def test_audit_result_detects_tampering_as_jax_does(synth, tamper, law):
    """A tampered result fails the law JAX's auditor names, with JAX's
    message — every margin in it equal — for the same streams and
    result."""
    pst, refs = synth
    res = run_policy_streams(pst, policy="bfjs", **CFG)
    audit_result(pst, res, policy="bfjs", config=_CFG)  # healthy
    delta = {"occupancy": 100.0, "departed": 50, "queue_len": -1000,
             "lost": 3}[tamper]
    evil = res._replace(**{tamper: getattr(res, tamper) + delta})
    with pytest.raises(InvariantViolation, match=law) as e:
        audit_result(pst, evil, policy="bfjs", config=_CFG)
    j_evil = refs["bfjs"]._replace(
        **{tamper: getattr(refs["bfjs"], tamper) + delta})
    with pytest.raises(j_sup.InvariantViolation) as je:
        j_sup.audit_result(_jax_streams(), j_evil, policy="bfjs",
                           config=_CFG)
    assert str(e.value) == str(je.value)
    assert e.value.invariant == law and e.value.chunk_index is None


def test_audit_names_chunk_and_invariant(synth, monkeypatch):
    """Tamper with the engine output mid-stream: the violation names the
    chunk index and the failed counter."""
    from repro_torch.core.engine import streaming as streaming_mod
    real = streaming_mod._STATEFUL["bfjs"]

    def tampered(s, st, config):
        res, new_st = real(s, st, config)
        return res._replace(queue_len=res.queue_len - 1000), new_st

    monkeypatch.setitem(streaming_mod._STATEFUL, "bfjs", tampered)
    with pytest.raises(InvariantViolation) as e:
        _run(iter_stream_chunks(synth[0], 7), audit=True)
    assert e.value.invariant == "queue_nonneg"
    assert e.value.chunk_index == 0
    assert "stream chunk 0" in str(e.value)
    assert isinstance(e.value, ValueError)


def test_audit_requires_explicit_L_and_K(synth):
    with pytest.raises(ValueError, match="L= and K="):
        stream_policy(iter_stream_chunks(synth[0], 7), policy="bfjs",
                      audit=True, A_max=4, Qcap=48, device="cpu")
    with pytest.raises(ValueError, match="L= and K="):
        audit_result(synth[0], run_policy_streams(synth[0], **CFG),
                     policy="bfjs", config=dict(Qcap=48))


def test_api_audit_knob(synth):
    pst, refs = synth
    for kw in ({}, {"chunk": 13}):
        res = run_policy_streams(pst, policy="bfjs", engine="scan",
                                 audit=True, **kw, **CFG)
        assert_matches_jax(res, refs["bfjs"], "bfjs", f"audit {kw}")


# ---------------------------------------------------------------------------
# ResumableTraceReader under supervision
# ---------------------------------------------------------------------------

def _reader_kwargs():
    cc, mc = trace_mod.scan_trace_maxima(FIXTURE)
    return dict(chunk_rows=13, slot_seconds=10.0, cpu_capacity=cc,
                mem_capacity=mc)


class _FlakyReader(trace_mod.ResumableTraceReader):
    """Transport that dies on its 3rd chunk for the first two passes."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.passes = 0

    def _open(self):
        self.passes += 1
        gen = super()._open()
        if self.passes <= 2:
            def wrap(g=gen):
                for i, c in enumerate(g):
                    if i == 2:
                        raise OSError("flaky NFS")
                    yield c
            return wrap()
        return gen


def test_supervised_trace_stream_end_to_end_bit_exact():
    kw = _reader_kwargs()
    cfg = dict(L=4, K=5, Qcap=48, J=3, policy="vqs", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clean = stream_policy(
            stream_chunks_from_trace(trace_mod.iter_trace_csv(FIXTURE,
                                                              **kw),
                                     chunk_slots=16, A_max=12), **cfg)
        reader = _FlakyReader(FIXTURE, **kw)
        res = stream_policy(
            stream_chunks_from_trace(reader, chunk_slots=16, A_max=12),
            supervisor=_sup(), audit=True, **cfg)
    assert_bitmatch(clean, res, "flaky-trace-e2e")
    assert res.retries == 2 and res.quarantined == 0
    assert reader.reopens == 2


# ---------------------------------------------------------------------------
# SIGKILL + corruption end-to-end (subprocess)
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, signal, sys
import numpy as np
from repro_torch.convert import streams_from_numpy
from repro_torch.core.engine import iter_stream_chunks, stream_policy
from repro_torch.core.engine import streaming as streaming_mod

ckdir, planes, kills_after = sys.argv[1], np.load(sys.argv[2]), \
    int(sys.argv[3])
streams = streams_from_numpy(planes["n"], planes["sizes"], planes["durs"],
                             device="cpu")
saves = [0]
real = streaming_mod._save_step

def killing_save(checkpoint_dir, step, payload, extra):
    real(checkpoint_dir, step, payload, extra)
    saves[0] += 1
    if saves[0] >= kills_after:
        os.kill(os.getpid(), signal.SIGKILL)

streaming_mod._save_step = killing_save
stream_policy(iter_stream_chunks(streams, 7), policy="bfjs",
              checkpoint_dir=ckdir, L=4, K=5, Qcap=48, A_max=4,
              device="cpu")
sys.exit("survived past the kill point")
"""


def test_sigkill_then_corruption_then_supervised_resume(synth, tmp_path):
    """SIGKILL mid-stream in a process that imports only the port, corrupt
    the newest surviving checkpoint, supervised and audited resume: equal
    to JAX's one-shot run."""
    pst, refs = synth
    planes = tmp_path / "streams.npz"
    np.savez(planes, n=pst.n.numpy(), sizes=pst.sizes.numpy(),
             durs=pst.durs.numpy())
    ck = tmp_path / "ck"
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(ck), str(planes), "3"],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert ckpt.list_steps(str(ck)) == [1, 2, 3]
    _corrupt(ck / "step_00000003" / "arrays.npz", "truncate")
    with pytest.warns(CheckpointRollbackWarning):
        res = _run(iter_stream_chunks(pst, 7), checkpoint_dir=str(ck),
                   resume=True, supervisor=_sup(), audit=True)
    assert res.rollbacks == 1
    assert_matches_jax(res, refs["bfjs"], "bfjs", "sigkill-corrupt-resume")
