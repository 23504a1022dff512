"""The port's admission controller and serving engine on the CPU against the
JAX package: placements and residuals equal under random operation
sequences, and the f32 smoke engine equal token for token."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cluster.admission import \
    AdmissionController as JAdmission  # noqa: E402
from repro.cluster.admission import PendingJob as JJob  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.partition import PartitionI as JPartition  # noqa: E402
from repro.core.quantize import from_grid as j_from_grid  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.cluster.admission import (ADMISSION_POLICIES,  # noqa: E402
                                           AdmissionController, PendingJob)
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.partition import PartitionI  # noqa: E402
from repro_torch.core.quantize import RES, from_grid  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import (Cluster,  # noqa: E402
                                        InvariantViolation, Request,
                                        ServingEngine)


@pytest.fixture(scope="module")
def smoke():
    """The f32 llama3-8b smoke model in both packages, same weights."""
    jc = j_smoke("llama3-8b").with_(dtype="float32")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def test_partition_and_grid_match_jax():
    sizes = np.concatenate([np.arange(1, 70), np.linspace(1, RES, 500)
                            .astype(np.int64), [RES // 3, 2 * RES // 3]])
    for J in (2, 4, 6, 10):
        mine, ref = PartitionI(J), JPartition(J)
        np.testing.assert_array_equal(mine.type_of(sizes), ref.type_of(sizes))
        np.testing.assert_array_equal(mine.effective_size(sizes),
                                      ref.effective_size(sizes))
        for j in range(2 * J):
            assert mine.upper_bound_int(j) == ref.upper_bound_int(j)
            assert mine.interval(j) == ref.interval(j)
    np.testing.assert_array_equal(from_grid(sizes), j_from_grid(sizes))
    with pytest.raises(ValueError, match="J must be"):
        PartitionI(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ADMISSION_POLICIES)
def test_admission_matches_jax_under_random_operations(policy, seed):
    """Random admit / release + refill / push_front sequences: the same
    placements, queue, residuals and virtual-queue counters."""
    rng = np.random.default_rng(seed)
    L = 3
    mine = AdmissionController(L, policy=policy, J=4)
    ref = JAdmission(L, policy=policy, J=4)
    frac_of = {}           # rid -> KV fraction
    resident = []          # (rid, replica) placed and not released
    placed = 0

    def jobs(rids):
        return ([PendingJob(r, frac_of[r]) for r in rids],
                [JJob(r, frac_of[r]) for r in rids])

    for _ in range(200):
        op = rng.choice(["admit", "release", "push_front"], p=[.45, .4, .15])
        if op == "admit":
            n = int(rng.integers(1, 5))
            rids = range(len(frac_of), len(frac_of) + n)
            frac_of.update(zip(rids, rng.uniform(0.02, 0.9, n)))
            mj, jj = jobs(rids)
            got, want = mine.admit(mj), ref.admit(jj)
        elif resident:
            rid, rep = resident.pop(int(rng.integers(len(resident))))
            size = PendingJob(rid, frac_of[rid]).size
            mine.release(rep, size)
            ref.release(rep, size)
            if op == "release":        # a completion, then BF-S refill
                got, want = mine.refill(rep), ref.refill(rep)
            else:                      # the engine's slot-rejection path
                (mj,), (jj,) = jobs([rid])
                mine.push_front(mj)
                ref.push_front(jj)
                got = want = []
        else:
            continue
        assert got == want
        resident.extend(got)
        placed += len(got)
        np.testing.assert_array_equal(mine.residual, ref.residual)
        assert [(j.rid, j.size) for j in mine.queue] == \
            [(j.rid, j.size) for j in ref.queue]
        np.testing.assert_array_equal(mine._vq_sizes, ref._vq_sizes)
        np.testing.assert_array_equal(mine._resident, ref._resident)
    assert len(frac_of) > 100 and placed > 10


def test_admission_rejects_bad_input():
    with pytest.raises(ValueError, match="unknown admission policy"):
        AdmissionController(2, policy="lifo")
    ac = AdmissionController(1)
    with pytest.raises(ValueError, match="exceeds capacity"):
        ac.release(0, 1)
    with pytest.raises(ValueError, match="unknown replica"):
        ac.release(3, 0)


def _requests(R, vocab):
    """The requests of tests/test_serving_cluster.py's engine test."""
    rng = np.random.default_rng(0)
    return [R(rid=i,
              prompt=rng.integers(1, vocab, size=rng.integers(4, 20))
              .astype(np.int32),
              max_new=int(rng.integers(4, 12)))
            for i in range(10)]


@pytest.mark.parametrize("policy", ["bf", "vqs-bf"])
def test_engine_matches_jax_token_for_token(smoke, policy):
    jc, tc, jp, tp = smoke
    kw = dict(num_replicas=2, b_slots=3, c_max=64, policy=policy)
    ref = JEngine(jc, jp, **kw)
    ref.submit(_requests(JRequest, jc.vocab_size))
    ref_done = ref.run(max_steps=600)
    eng = ServingEngine(tc, tp, audit=True, device="cpu", **kw)
    eng.submit(_requests(Request, tc.vocab_size))
    done = eng.run(max_steps=600)
    assert len(done) == 10
    assert [(r.rid, r.replica, r.slot, r.out) for r in done] == \
        [(r.rid, r.replica, r.slot, r.out) for r in ref_done]
    assert eng.stats == ref.stats
    assert max(eng.stats["queue_len"]) > 0
    np.testing.assert_array_equal(eng.admission.residual, RES)
    # the inactive slots decoded token 0 at position 0, as in JAX
    for rep, jrep in zip(eng.replicas, ref.replicas):
        k = rep.caches[0].k.numpy().transpose(0, 2, 1, 3)
        np.testing.assert_allclose(k, np.asarray(jrep.caches["p0"].k)[0],
                                   atol=1e-5, rtol=1e-5)


def test_argmax_ties_pick_the_first_token(smoke):
    """A zero LM head ties every logit: both engines emit token 0 (the
    first maximal index) throughout."""
    jc, tc, jp, tp = smoke
    jp = {**jp, "head": {"w": jp["head"]["w"] * 0}}
    tp = {**tp, "head": {"w": tp["head"]["w"] * 0}}
    outs = []
    for eng, R in ((JEngine(jc, jp, num_replicas=1, b_slots=2, c_max=32),
                    JRequest),
                   (ServingEngine(tc, tp, num_replicas=1, b_slots=2,
                                  c_max=32, device="cpu"), Request)):
        eng.submit(_requests(R, jc.vocab_size)[:3])
        outs.append([r.out for r in eng.run(max_steps=200)])
    assert outs[0] == outs[1]
    assert {t for out in outs[1] for t in out} == {0}


def test_queue_drains_in_arrival_waves(smoke):
    """The mirror of test_serving_queue_drains_in_arrival_waves, with the
    JAX engine's stats alongside."""
    jc, tc, jp, tp = smoke
    engines = [JEngine(jc, jp, num_replicas=1, b_slots=2, c_max=48),
               ServingEngine(tc, tp, num_replicas=1, b_slots=2, c_max=48,
                             device="cpu")]
    for eng, R in zip(engines, (JRequest, Request)):
        rng = np.random.default_rng(1)
        for wave in range(3):
            eng.submit([R(rid=wave * 10 + i,
                          prompt=rng.integers(1, 64, size=8).astype(np.int32),
                          max_new=4) for i in range(4)])
            for _ in range(30):
                eng.step()
        eng.run(max_steps=400)
    ref, eng = engines
    assert len(eng.completed) == 12
    assert eng.admission.queue_len() == 0
    assert [r.out for r in eng.completed] == [r.out for r in ref.completed]
    assert eng.stats == ref.stats


def test_engine_options_and_invariants(smoke):
    _, tc, _, tp = smoke
    live = ServingEngine(tc, tp, num_replicas=3, b_slots=2, admission="live",
                         device="cpu")
    assert type(live.admission).__name__ == "LiveAdmission"
    assert live.admission.tick_width == 6 and live.admission.Qcap == 512
    with pytest.raises(ValueError, match="unknown admission"):
        ServingEngine(tc, tp, admission="remote", device="cpu")
    assert Cluster is ServingEngine
    eng = ServingEngine(tc, tp, num_replicas=1, b_slots=2, c_max=32,
                        device="cpu")
    eng.submit(_requests(Request, tc.vocab_size)[:3])
    eng.step()
    eng.check_invariants()
    eng.replicas[0].slots[0].slot = 1
    with pytest.raises(InvariantViolation, match="slot map") as err:
        eng.check_invariants()
    assert err.value.invariant == "slot_map"
    assert isinstance(err.value, ValueError)


def _long_requests(R, vocab):
    """Six requests of 30-60 prompt tokens and 20-35 new ones: up to 95
    positions, past two turns of h2o-danube's smoke window (32)."""
    rng = np.random.default_rng(3)
    return [R(rid=i,
              prompt=rng.integers(1, vocab, size=rng.integers(30, 61))
              .astype(np.int32),
              max_new=int(rng.integers(20, 36)))
            for i in range(6)]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "h2o-danube-3-4b",
                                  "jamba-1.5-large-398b"])
def test_new_arch_engines_match_jax_token_for_token(arch):
    """MLA with MoE, the sliding-window ring with c_max = 96 over a window
    of 32 (six long requests: the ring wraps), and Jamba's mix of Mamba,
    attention and MoE (six of the short requests above): the f32 smoke
    engines equal JAX's in placements, tokens and stats."""
    jc = j_smoke(arch).with_(dtype="float32")
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    kw = dict(num_replicas=2, b_slots=2, c_max=96, policy="bf")

    def reqs(R):
        return _long_requests(R, tc.vocab_size) if tc.sliding_window \
            else _requests(R, tc.vocab_size)[:6]
    ref = JEngine(jc, jp, **kw)
    ref.submit(reqs(JRequest))
    ref_done = ref.run(max_steps=2000)
    eng = ServingEngine(tc, tp, audit=True, device="cpu", **kw)
    eng.submit(reqs(Request))
    done = eng.run(max_steps=2000)
    assert len(done) == 6
    assert [(r.rid, r.replica, r.slot, r.out) for r in done] == \
        [(r.rid, r.replica, r.slot, r.out) for r in ref_done]
    assert eng.stats == ref.stats
    if tc.sliding_window:
        assert eng.replicas[0].caches[0].k.shape[2] == tc.sliding_window
        assert max(r.pos for r in done) > 2 * tc.sliding_window
