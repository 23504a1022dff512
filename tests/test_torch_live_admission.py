"""The port's device-resident admission (serving/live.py, the
live_admission kernel's plain version on the CPU) against the JAX
package's ``LiveAdmission`` lane for lane — every state plane and counter
after every call — and against the port's host ``AdmissionController``
placement for placement: every case of tests/test_live_admission.py, the
step functions, and ``ServingEngine(admission="live")`` against
``"host"``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cluster.admission import PendingJob as JJob  # noqa: E402
from repro.serving import live as jlive  # noqa: E402
from repro_torch.cluster.admission import (AdmissionController,  # noqa: E402
                                           PendingJob)
from repro_torch.core.engine.supervisor import \
    InvariantViolation  # noqa: E402
from repro_torch.core.quantize import RES, to_grid  # noqa: E402
from repro_torch.kernels.live_admission import \
    live_admission as kernel  # noqa: E402
from repro_torch.serving import live  # noqa: E402
from repro_torch.serving.live import LiveAdmission  # noqa: E402


def _job(rid, frac):
    return PendingJob(rid=rid, frac=frac)


def _trio(L, **kw):
    """The port's host controller, JAX's LiveAdmission and the port's."""
    return (AdmissionController(L), jlive.LiveAdmission(L, **kw),
            LiveAdmission(L, device="cpu", **kw))


def _same_state(j, t):
    """Every plane and counter of the port's state equals JAX's."""
    for f in jlive.LiveAdmissionState._fields:
        np.testing.assert_array_equal(
            getattr(t.state, f).numpy(), np.asarray(getattr(j.state, f)),
            err_msg=f)


def _both(jl, tl, method, *args):
    """Call ``method`` on both live controllers; the results are equal."""
    jargs = [JJob(rid=a.rid, frac=a.frac) if isinstance(a, PendingJob)
             else [JJob(rid=x.rid, frac=x.frac) for x in a]
             if isinstance(a, list) and a and isinstance(a[0], PendingJob)
             else a for a in args]
    got, want = getattr(tl, method)(*args), getattr(jl, method)(*jargs)
    assert got == want, method
    _same_state(jl, tl)
    return got


def test_admit_best_fit_order_matches_host_and_jax():
    host, jl, tl = _trio(3, Qcap=16)
    jobs = [_job(0, 0.5), _job(1, 0.3), _job(2, 0.4), _job(3, 0.9),
            _job(4, 0.2)]
    assert host.admit(list(jobs)) == _both(jl, tl, "admit", list(jobs))
    np.testing.assert_array_equal(host.residual, tl.residual)
    assert host.queue_len() == tl.queue_len() == jl.queue_len()
    assert tl.calls == 1


def test_refill_largest_first_earliest_on_ties():
    host, jl, tl = _trio(1, Qcap=16)
    fill = [_job(0, 1.0)]
    host.admit(list(fill)), _both(jl, tl, "admit", list(fill))
    queued = [_job(1, 0.3), _job(2, 0.5), _job(3, 0.5), _job(4, 0.2)]
    host.admit(list(queued)), _both(jl, tl, "admit", list(queued))
    full = int(to_grid([1.0])[0])
    host.release(0, full)
    _both(jl, tl, "release", 0, full)
    ph, pl = host.refill(0), _both(jl, tl, "refill", 0)
    assert ph == pl
    rids = [r for r, _ in pl]
    assert rids.index(2) < rids.index(3)
    np.testing.assert_array_equal(host.residual, tl.residual)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_tick_parity(seed):
    """200 randomized ticks of arrivals and completions: every placement,
    residual, queue lane and counter equal to JAX's, and every placement
    to the host controller's."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(2, 8))
    host, jl, tl = _trio(L, Qcap=64, tick_width=16)
    size_of, active, rid = {}, {}, 0
    for t in range(200):
        jobs = []
        for _ in range(int(rng.integers(0, 4))):
            j = _job(rid, float(rng.uniform(0.05, 0.95)))
            size_of[rid] = j.size
            jobs.append(j)
            rid += 1
        ph = host.admit(list(jobs))
        assert ph == _both(jl, tl, "admit", list(jobs)), t
        active.update(ph)
        done = [r for r in list(active) if rng.uniform() < 0.3]
        events = [(active.pop(r), size_of[r]) for r in done]
        ph2 = []
        for rep, size in events:
            host.release(rep, size)
        for rep in sorted({rep for rep, _ in events}):
            ph2 += host.refill(rep)
        pl2 = _both(jl, tl, "tick", events)
        assert ph2 == pl2, t
        active.update(pl2)
        assert host.queue_len() == tl.queue_len(), t
        np.testing.assert_array_equal(host.residual, tl.residual)
    assert tl.dropped == 0


def test_push_front_outranks_queue_and_counts_tail_drop():
    host, jl, tl = _trio(1, Qcap=2)
    fill = [_job(0, 1.0)]
    host.admit(list(fill)), _both(jl, tl, "admit", list(fill))
    q1, q2 = _job(1, 0.4), _job(2, 0.3)
    host.admit([q1]), _both(jl, tl, "admit", [q1])
    host.push_front(q2)
    _both(jl, tl, "push_front", q2)
    assert host.queue[0].rid == 2
    assert int(tl.state.q_rid[0]) == 2
    assert host.queue_len() == tl.queue_len() == 2
    _both(jl, tl, "push_front", _job(3, 0.2))
    assert tl.queue_len() == 2 and tl.dropped == 1
    assert int(tl.state.q_rid[0]) == 3


def test_queue_overflow_counts_dropped():
    _, jl, tl = _trio(1, Qcap=2)
    _both(jl, tl, "admit", [_job(0, 1.0)])
    placed = _both(jl, tl, "admit", [_job(1, 0.5), _job(2, 0.5),
                                     _job(3, 0.5)])
    assert placed == []
    assert tl.queue_len() == 2 and tl.dropped == 1


def test_invalid_release_counted_then_raised_on_sync():
    _, jl, tl = _trio(2, Qcap=4)
    for rep, size in ((0, RES + 1), (5, 10), (1, -3)):
        _both(jl, tl, "release", rep, size)
    with pytest.raises(InvariantViolation, match="3 invalid release") as e:
        tl.queue_len()
    assert e.value.invariant == "occupancy_capacity"
    host = AdmissionController(2)
    with pytest.raises(ValueError, match="exceeds capacity"):
        host.release(0, RES + 1)
    with pytest.raises(ValueError, match="unknown replica"):
        host.release(5, 10)
    with pytest.raises(ValueError, match="negative size"):
        host.release(1, -3)


def test_tick_width_guard():
    tl = LiveAdmission(2, Qcap=4, tick_width=2, device="cpu")
    with pytest.raises(ValueError, match="tick_width"):
        tl.tick([(0, 1), (0, 1), (1, 1)])
    assert tl.calls == 0


# ---------------------------------------------------------------------------
# the step functions against JAX's, and the kernel wrapper's checks
# ---------------------------------------------------------------------------

def _same(jst, tst):
    for f in jlive.LiveAdmissionState._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)


@pytest.mark.parametrize("seed", [3, 4])
def test_step_functions_match_jax(seed):
    """Random admit / release / tick / refill / push_front sequences with
    masked lanes, a small queue (overflow and tail drops) and invalid
    releases, through the step functions of both packages."""
    rng = np.random.default_rng(seed)
    L, Qcap, W = 5, 8, 6
    jst, tst = jlive.init_state(L, Qcap), live.init_state(L, Qcap, "cpu")
    for _ in range(120):
        op = rng.integers(0, 5)
        if op == 0:
            rids = rng.integers(0, 1000, W).astype(np.int32)
            sizes = rng.integers(1, RES, W).astype(np.int32)
            mask = rng.uniform(size=W) < 0.7
            jst, jp = jlive.admit_step(jst, rids, sizes, mask)
            tst, tp = live.admit_step(tst, rids, sizes, mask)
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        elif op in (1, 2):
            reps = rng.integers(-1, L + 1, W).astype(np.int32)
            sizes = rng.integers(-2, RES // 2, W).astype(np.int32)
            mask = rng.uniform(size=W) < 0.6
            if op == 1:
                jst = jlive.release_step(jst, reps, sizes, mask)
                tst = live.release_step(tst, reps, sizes, mask)
            else:
                jst, jo = jlive.tick_step(jst, reps, sizes, mask)
                tst, to = live.tick_step(tst, reps, sizes, mask)
                for a, b in zip(to, jo):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        elif op == 3:
            r = int(rng.integers(0, L))
            jst, jo = jlive.refill_step(jst, jax.numpy.asarray(r))
            tst, to = live.refill_step(tst, r)
            for a, b in zip(to, jo):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            rid, size = int(rng.integers(0, 1000)), int(rng.integers(1, RES))
            jst = jlive.push_front_step(jst, jax.numpy.asarray(rid),
                                        jax.numpy.asarray(size))
            tst = live.push_front_step(tst, rid, size)
        _same(jst, tst)
    assert int(tst.invalid) > 0 and int(tst.dropped) > 0


def test_kernel_wrapper_checks_its_inputs():
    st = live.init_state(2, 4, "cpu")
    with pytest.raises(ValueError, match="unknown op"):
        kernel.live_admission_cuda("evict", st)
    with pytest.raises(ValueError, match=r"ev must be \(3, A\)"):
        kernel.live_admission_cuda("admit", st, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="int32"):
        kernel.live_admission_cuda(
            "refill", st._replace(residual=st.residual.long()))
    assert kernel.shared_bytes(1000, 512) == 4 * (2000 + 1024)
    assert kernel.out_lanes("admit", 8, 3) == 7
    assert kernel.out_lanes("tick", 8, 3) == 20
    assert kernel.out_lanes("release", 8, 3) == 4


# ---------------------------------------------------------------------------
# ServingEngine integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """The f32 llama3-8b smoke model in both packages, same weights."""
    from repro.configs import get_smoke_config
    from repro.models import model as JM
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models.config import ModelConfig

    jc = get_smoke_config("llama3-8b").with_(dtype="float32")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _drive(make, Request, admission):
    eng = make(admission)
    rng = np.random.default_rng(0)
    rid = 0
    for _ in range(12):
        reqs = []
        for _ in range(int(rng.integers(0, 3))):
            prompt = np.arange(1 + int(rng.integers(0, 4)), dtype=np.int32)
            reqs.append(Request(rid=rid, prompt=prompt,
                                max_new=int(rng.integers(1, 6))))
            rid += 1
        eng.submit(reqs)
        eng.step()
    eng.run(max_steps=64)
    return eng


def test_serving_engine_live_matches_host_and_jax(smoke):
    """The engine under admission="live" equals "host" (completions, slots,
    tokens, stats) and JAX's live engine; each controller call that
    changes the state is one call of the kernel's wrapper."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import Request, ServingEngine

    jc, tc, jp, tp = smoke

    def port(admission):
        return ServingEngine(tc, tp, num_replicas=2, b_slots=2, c_max=32,
                             admission=admission, audit=True, device="cpu")

    def jax_engine(admission):
        return JEngine(jc, jp, num_replicas=2, b_slots=2, c_max=32,
                       admission=admission)

    host = _drive(port, Request, "host")
    eng = _drive(port, Request, "live")
    ref = _drive(jax_engine, JRequest, "live")
    for other in (host, ref):
        assert [(r.rid, r.replica, r.slot, r.out) for r in eng.completed] \
            == [(r.rid, r.replica, r.slot, r.out) for r in other.completed]
        assert eng.stats == other.stats
        np.testing.assert_array_equal(eng.admission.residual,
                                      np.asarray(other.admission.residual))
    assert eng.stats["rejected_slots"] > 0 and max(eng.stats["queue_len"])
    assert isinstance(eng.admission, LiveAdmission)
    assert eng.admission.tick_width == 4 and eng.admission.calls > 0


def test_engine_live_tick_batches_events(smoke, monkeypatch):
    """Each engine step with completions is one ``tick`` call, whatever
    replicas they free; ``refill`` is never called, and ``release`` only
    on the slot-rejection path."""
    from repro_torch.serving.engine import Request, ServingEngine

    _, tc, _, tp = smoke
    eng = ServingEngine(tc, tp, num_replicas=2, b_slots=2, c_max=32,
                        admission="live", device="cpu")
    calls = []
    for name in ("tick", "release", "refill"):
        real = getattr(eng.admission, name)
        monkeypatch.setattr(
            eng.admission, name,
            lambda *a, _real=real, _name=name: calls.append(_name)
            or _real(*a))
    eng.submit([Request(rid=i, prompt=np.arange(2 + i % 3, dtype=np.int32),
                        max_new=1 + i % 2) for i in range(7)])
    steps_with_completions = 0
    for _ in range(64):
        if eng.step():
            steps_with_completions += 1
        if len(eng.completed) == 7:
            break
    assert len(eng.completed) == 7
    assert calls.count("tick") == steps_with_completions
    assert "refill" not in calls
    assert calls.count("release") == eng.stats["rejected_slots"] > 0


def test_live_and_host_differ_alike_in_both_packages(smoke):
    """With two replicas, a request placed by one replica's refill and
    then rejected for want of a slot goes back to the queue's head before
    the next replica's refill on the host path, but after every refill of
    the tick on the live path (one fused call), so the two paths can place
    differently.  That is the JAX engine's behaviour: the port's host and
    live engines each equal JAX's, and differ from each other as JAX's
    do."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import Request, ServingEngine

    jc, tc, jp, tp = smoke

    def run(make, Req, admission):
        rng = np.random.default_rng(0)
        big = [(int(rng.integers(96, 121)), int(rng.integers(4, 9)))
               for _ in range(3)]
        small = [(int(rng.integers(4, 17)), int(rng.integers(2, 7)))
                 for _ in range(9)]
        eng = make(admission)
        eng.submit([Req(rid=i, prompt=rng.integers(
            1, 64, p).astype(np.int32), max_new=m)
            for i, (p, m) in enumerate(small[:3] + big + small[3:])])
        done = eng.run(max_steps=2000)
        return [(r.rid, r.replica, r.slot, r.out) for r in done], eng.stats

    def port(admission):
        return ServingEngine(tc, tp, num_replicas=2, b_slots=2, c_max=160,
                             admission=admission, device="cpu")

    def jax_engine(admission):
        return JEngine(jc, jp, num_replicas=2, b_slots=2, c_max=160,
                       admission=admission)

    host, live = run(port, Request, "host"), run(port, Request, "live")
    assert host == run(jax_engine, JRequest, "host")
    assert live == run(jax_engine, JRequest, "live")
    assert [r[:3] for r in host[0]] != [r[:3] for r in live[0]]
    assert host[1]["rejected_slots"] != live[1]["rejected_slots"]
