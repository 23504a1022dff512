"""The port's policy entry points: engines, devices, registry, and the
import boundary (the port never loads JAX or the JAX package)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core.engine import (Workload,  # noqa: E402
                                     available_policies, monte_carlo_policy,
                                     run_policy, run_policy_streams)
from repro_torch.kernels.bfjs import bfjs as bfjs_kernel  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = dict(L=4, K=6, Qcap=64, A_max=6, horizon=80)


def _sampler(gen, n, device):
    return torch.rand(n, generator=gen, device=device) * 0.45 + 0.05


def _equal(a, b):
    for x, y in zip(result_to_numpy(a), result_to_numpy(b)):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


def test_cuda_engine_on_cpu_equals_scan():
    """On CPU tensors the kernel wrapper runs its plain version, so the
    "cuda" engine is the scan engine bit for bit — and launches nothing."""
    wl = Workload(lam=1.2, mu=0.02, sampler=_sampler)
    before = bfjs_kernel.launches.count
    cuda = monte_carlo_policy(wl, seeds=[0, 1, 2], engine="cuda",
                              device="cpu", strict=True, **CFG)
    scan = monte_carlo_policy(wl, [0, 1, 2], engine="scan", device="cpu",
                              **CFG)
    assert bfjs_kernel.launches.count == before
    assert cuda.queue_len.shape == (3, 80) and cuda.dropped.shape == (3,)
    _equal(cuda, scan)


def test_run_policy_is_one_member_of_the_ensemble():
    wl = Workload(lam=1.2, mu=0.02, sampler=_sampler)
    ens = monte_carlo_policy(wl, seeds=[5, 9], device="cpu", **CFG)
    one = run_policy(wl, 9, device="cpu", **CFG)
    assert one.queue_len.shape == (80,)
    _equal(one, type(ens)(*(None if x is None else x[1] for x in ens)))
    assert int(ens.departed[:, -1].min()) > 0


def test_run_policy_streams_matches_jax():
    def j_sampler(key, n):
        return jax.random.uniform(key, (n,), minval=0.05, maxval=0.5)
    st = j_make_streams(jax.random.PRNGKey(4), 1.5, 0.02, j_sampler, L=4,
                        K=6, A_max=6, horizon=80)
    ref = j_rps(st, policy="bfjs", engine="scan", L=4, K=6, Qcap=64,
                A_max=6)
    got = run_policy_streams(
        streams_from_numpy(st.n, st.sizes, st.durs, device="cpu"),
        policy="bfjs", engine="cuda", L=4, K=6, Qcap=64, A_max=6)
    got = result_to_numpy(got)
    for f in ("queue_len", "departed", "dropped", "truncated"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(got.occupancy, np.asarray(ref.occupancy),
                               rtol=1e-6)


def test_registry_and_unported_options():
    wl = Workload(lam=1.0, mu=0.1, sampler=_sampler)
    assert available_policies() == ("bfjs", "bfjs-mr", "vqs", "vqs-bf")
    with pytest.raises(ValueError, match="unknown policy"):
        run_policy(wl, policy="bfjs-mr2", device="cpu", **CFG)
    with pytest.raises(ValueError, match="unknown engine"):
        run_policy(wl, engine="pallas", device="cpu", **CFG)
    # every policy runs engine="reference", one cluster or an ensemble,
    # and equals its scan engine here (nothing is truncated)
    for policy in available_policies():
        extra = dict(J=3, K=8) if policy.startswith("vqs") else {}
        ref = run_policy(wl, 3, policy=policy, engine="reference",
                         device="cpu", **{**CFG, **extra})
        ens = monte_carlo_policy(wl, [5, 3], policy=policy,
                                 engine="reference", device="cpu",
                                 **{**CFG, **extra})
        scan = monte_carlo_policy(wl, [5, 3], policy=policy, engine="scan",
                                  device="cpu", work_steps=48,
                                  **{**CFG, **extra})
        assert ref.queue_len.shape == (80,) and ens.dropped.shape == (2,)
        assert int(scan.truncated.sum()) == 0
        _equal(ens, scan)
        _equal(ref, type(ens)(*(None if x is None else x[1] for x in ens)))
    # as in JAX, bfjs's oracle is not offered on explicit streams
    with pytest.raises(ValueError, match="no stream-driven reference"):
        run_policy_streams(
            streams_from_numpy(np.zeros(4), np.zeros((4, 6)),
                               np.ones((4, 4 * 6 + 6)), device="cpu"),
            engine="reference", L=4, K=6, Qcap=8, A_max=6)
    for policy in ("vqs", "vqs-bf"):
        with pytest.raises(ValueError, match="single-resource"):
            run_policy(Workload(lam=1.0, mu=0.1, sampler=_sampler,
                                num_resources=2), policy=policy,
                       device="cpu", **CFG)
    # bfjs-mr takes no unknown engine either
    ref = run_policy(wl, policy="bfjs-mr", engine="reference", device="cpu",
                     **CFG)
    assert ref.occupancy.shape == (80, 1)
    with pytest.raises(ValueError, match="unknown engine"):
        run_policy(wl, policy="bfjs-mr", engine="pallas", device="cpu",
                   **CFG)
    # only the ensemble sharding over several cards is left unported
    st = streams_from_numpy(np.zeros(4), np.zeros((4, 6)),
                            np.ones((4, 30)), device="cpu")
    for kw in (dict(mesh=object()), dict(devices=2),
               dict(devices=2, chunk=10)):
        with pytest.raises(NotImplementedError, match="item 9"):
            monte_carlo_policy(wl, seeds=[0], device="cpu", **kw, **CFG)
        with pytest.raises(NotImplementedError, match="item 9"):
            run_policy_streams(st, L=4, K=6, Qcap=8, A_max=6, **kw)
    # chunked sweeps and the audit run (tests/test_torch_chunked.py and
    # tests/test_torch_supervisor.py hold them to JAX)
    chunked = monte_carlo_policy(wl, seeds=[0, 1], device="cpu", chunk=30,
                                 **CFG)
    _equal(chunked, monte_carlo_policy(wl, seeds=[0, 1], device="cpu",
                                       **CFG))
    run_policy_streams(st, audit=True, L=4, K=6, Qcap=8, A_max=6)
    with pytest.raises(TypeError, match="seeds="):
        monte_carlo_policy(wl, device="cpu", **CFG)
    with pytest.raises(TypeError, match="Workload"):
        run_policy(0, device="cpu", **CFG)
    with pytest.raises(ValueError, match="single-resource"):
        run_policy(Workload(lam=1.0, mu=0.1, sampler=_sampler,
                            num_resources=2), device="cpu", **CFG)


def test_registry_covers_every_jax_policy():
    """The port registers exactly the JAX package's policies, so none can
    be left unported unnoticed."""
    from repro.core.engine import available_policies as j_available
    assert available_policies() == tuple(j_available())


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA; without a card it raises and names the
    way out — it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = Workload(lam=1.0, mu=0.1, sampler=_sampler)
    for call in (lambda: run_policy(wl, **CFG),
                 lambda: monte_carlo_policy(wl, seeds=[0], **CFG),
                 lambda: streams_from_numpy(np.zeros(2), np.zeros((2, 1)),
                                            np.zeros((2, 1)))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('core.engine.vqs', 'core.engine.vqs_bf', "
        "'kernels.vqs.vqs', 'kernels.vqs_bf.vqs_bf', 'core.partition', "
        "'core.engine.bfjs_mr', 'core.multi_resource', "
        "'kernels.bfjs_mr.bfjs_mr', 'models.model', 'models.attention', "
        "'configs.registry', 'configs.llama3_8b', 'cluster.admission', "
        "'serving.engine', 'kernels.decode_attention.decode_attention', "
        "'kernels.flash_attention.flash_attention', 'models.mamba2', "
        "'configs.mamba2_130m', 'kernels.ssd_scan.ssd_scan', "
        "'kernels.ssd_scan.ops', 'kernels.ssd_scan.ref', "
        "'core.fenwick', 'core.queues', 'core.cluster_state', "
        "'core.distributions', 'core.base', 'core.simulator', "
        "'core.best_fit', 'core.fifo', 'core.vqs', 'core.vqs_bf', "
        "'core.stability', 'core.maxweight', 'core.engine.supervisor', "
        "'core.trace', 'checkpoint.ckpt', 'core.engine.chunked', "
        "'core.engine.streaming', 'core.engine.sharding'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("corrupt,invariant", [
    ("residual", "occupancy_capacity"), ("overfull", "queue_nonneg")])
def test_invariant_violation_is_one_class(corrupt, invariant):
    """The serving engine and the event-driven cluster raise the one
    InvariantViolation of core.engine.supervisor, naming the law."""
    from repro_torch.core import RES, Cluster, Job
    from repro_torch.core.engine import supervisor
    from repro_torch.serving import engine as serving_engine
    assert serving_engine.InvariantViolation is \
        supervisor.InvariantViolation
    cl = Cluster(3)
    cl.place(1, Job(0, RES // 4, RES // 4, -1, 0), 10)
    cl.check_invariants()
    if corrupt == "residual":
        cl.residual[1] += 1
    else:                       # occupied past capacity, residuals agreeing
        cl.jobs[2][1] = Job(1, RES + 5, RES + 5, -1, 0)
        cl.residual[2] = -5
    with pytest.raises(supervisor.InvariantViolation) as err:
        cl.check_invariants()
    assert err.value.invariant == invariant
    assert isinstance(err.value, ValueError)
    assert err.value.chunk_index is None


def test_vqs_policies_match_jax_through_the_registry():
    """run_policy_streams(policy="vqs"|"vqs-bf") on JAX streams equals the
    JAX registry on every field; BF-J/S keeps rejecting trace-shaped
    streams, which the VQS policies replay."""
    from repro_torch.core.engine import streams_from_trace

    def j_sampler(key, n):
        return jax.random.uniform(key, (n,), minval=0.05, maxval=0.9)
    st = j_make_streams(jax.random.PRNGKey(2), 1.0, 0.03, j_sampler, L=4,
                        K=8, A_max=5, horizon=80)
    kw = dict(J=3, L=4, K=8, Qcap=48, A_max=5)
    port_st = streams_from_numpy(st.n, st.sizes, st.durs, device="cpu")
    for policy in ("vqs", "vqs-bf"):
        ref = j_rps(st, policy=policy, engine="scan", **kw)
        got = result_to_numpy(run_policy_streams(port_st, policy=policy,
                                                 engine="scan", **kw))
        for f in ("queue_len", "occupancy", "departed", "dropped",
                  "truncated"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(ref, f)))
    rng = np.random.default_rng(0)
    slots = np.sort(rng.integers(0, 30, 40))
    trace = streams_from_trace(slots, rng.uniform(0.05, 0.9, 40),
                               rng.integers(1, 20, 40), device="cpu")
    with pytest.raises(ValueError, match="Trace-built streams"):
        run_policy_streams(trace, policy="bfjs", L=4, K=8, Qcap=48,
                           A_max=int(trace.sizes.shape[1]))
    tk = dict(J=3, L=4, K=8, Qcap=48, A_max=int(trace.sizes.shape[1]))
    res = run_policy_streams(trace, policy="vqs", **tk)
    assert int(res.departed[-1]) > 0 and int(res.dropped) == 0
