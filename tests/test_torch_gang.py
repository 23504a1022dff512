"""The port's gang scheduler (cluster/gang.py) against the JAX package's:
tests/test_serving_cluster.py's failure-recovery case, and the two
schedulers tick by tick on the same seed — placements, progress, restarts
and queue length after every slot and every pod failure."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cluster.gang import GangScheduler as JGang  # noqa: E402
from repro.cluster.gang import TrainJob as JTrainJob  # noqa: E402
from repro_torch.cluster.gang import GangScheduler, TrainJob  # noqa: E402


def test_gang_recovers_from_failures():
    gs = GangScheduler(num_pods=3, seed=1)
    gs.submit([TrainJob(jid=i, hbm_frac=0.4, steps_total=15)
               for i in range(6)])
    for t in range(80):
        gs.tick()
        if t == 8:
            victims = gs.fail_pod(1)
            assert victims  # something was actually running there
    gs.cluster.check_invariants()
    assert all(j.steps_done >= j.steps_total for j in gs.jobs.values())
    assert any(j.restarts > 0 for j in gs.jobs.values())


def _snapshot(gs):
    return ([(j.jid, j.pod, j.steps_done, j.restarts)
             for j in gs.jobs.values()], gs.queued(), sorted(gs.running()),
            [sorted(gs.cluster.jobs[p]) for p in range(gs.cluster.L)],
            gs.cluster.residual.tolist(), gs.cluster.busy_area)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_matches_jax_tick_by_tick(seed):
    """Random waves of jobs with random footprints and lengths, and random
    pod failures, through both schedulers on one seed."""
    rng = np.random.default_rng(seed)
    pods = int(rng.integers(2, 6))
    mine, ref = GangScheduler(pods, seed=seed), JGang(pods, seed=seed)
    jid = 0
    for t in range(120):
        if rng.uniform() < 0.2:
            spec = [(jid + i, float(rng.uniform(0.05, 0.9)),
                     int(rng.integers(1, 30)))
                    for i in range(int(rng.integers(1, 5)))]
            jid += len(spec)
            mine.submit([TrainJob(j, f, s) for j, f, s in spec])
            ref.submit([JTrainJob(j, f, s) for j, f, s in spec])
        mine.tick()
        ref.tick()
        if rng.uniform() < 0.05:
            pod = int(rng.integers(0, pods))
            assert mine.fail_pod(pod) == ref.fail_pod(pod), t
        assert _snapshot(mine) == _snapshot(ref), t
    mine.cluster.check_invariants()
    assert any(j.restarts for j in mine.jobs.values())
