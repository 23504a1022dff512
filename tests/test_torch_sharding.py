"""The port's ensemble split over devices (core/engine/sharding.py) and
``estimate_capacity`` (serving/engine.py) on the CPU: the counterpart of
tests/test_sharded_mc.py's mesh half and of
tests/test_serving_cluster.py's capacity case.

The CPU is one torch device, so the split and the merge run on repeated
device entries (``devices=["cpu"] * k``); the entries ``"cpu"`` and
``"cpu:0"`` compare unequal, so a mesh of both also runs the one-thread-
per-device path.  Sharded results must equal the unsharded port run on
every field, for every policy and engine; chunked sweeps on JAX-made
ensemble streams must equal JAX's chunked sweep on a 1-device mesh; a
checkpoint taken on 4 shards resumes on 2 bit-exactly."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import make_streams as j_make_streams  # noqa: E402
from repro.core.engine import run_policy_streams as j_rps  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.convert import (result_to_numpy,  # noqa: E402
                                 streams_from_numpy)
from repro_torch.core.engine import (ENSEMBLE_AXIS, Workload,  # noqa: E402
                                     monte_carlo_policy, resolve_mesh,
                                     run_chunked, run_policy_streams,
                                     sharded_monte_carlo)
from repro_torch.core.engine import sharding  # noqa: E402
from repro_torch.serving.engine import estimate_capacity  # noqa: E402

G = 4
SEEDS = [5, 6, 7, 8]


def _scalar(gen, n, device):
    return torch.rand(n, generator=gen, device=device) * 0.45 + 0.05


def _vec(gen, n, device):
    return torch.rand((n, 2), generator=gen, device=device) * 0.45 + 0.05


#: policy -> (Workload, config): tests/test_sharded_mc.py's shapes (vqs-bf
#: with vqs's J), on the CPU.
MATRIX = {
    "bfjs": (Workload(lam=1.2, mu=0.05, sampler=_scalar),
             dict(L=4, K=6, Qcap=64, A_max=5, horizon=96)),
    "vqs": (Workload(lam=1.0, mu=0.05, sampler=_scalar),
            dict(L=4, K=8, Qcap=64, A_max=5, horizon=96, J=3)),
    "vqs-bf": (Workload(lam=1.0, mu=0.05, sampler=_scalar),
               dict(L=4, K=8, Qcap=64, A_max=5, horizon=96, J=3,
                    work_steps=64)),
    "bfjs-mr": (Workload(lam=0.5, mu=0.05, sampler=_vec, num_resources=2,
                         capacity=(1.0, 0.75)),
                dict(L=4, K=8, Qcap=64, A_max=5, horizon=96,
                     work_steps=24)),
}


def _assert_equal(res, ref, msg):
    assert len(res) == len(ref)
    for f, a, b in zip(ref._fields, res, ref):
        assert (a is None) == (b is None), (msg, f)
        if a is not None:
            assert a.device == b.device, (msg, f)
            assert torch.equal(a, b), f"{msg}: field {f!r}"


# ---------------------------------------------------------------------------
# sharded == unsharded, every policy x engine, 1, 2 and 4 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ("reference", "scan", "cuda"))
@pytest.mark.parametrize("policy", sorted(MATRIX))
def test_mesh_parity_every_policy_engine(policy, engine):
    wl, cfg = MATRIX[policy]
    ref = monte_carlo_policy(wl, SEEDS, policy=policy, engine=engine,
                             device="cpu", **cfg)
    assert int(ref.truncated.sum()) == 0
    for k in (1, 2, 4):
        res = monte_carlo_policy(wl, SEEDS, policy=policy, engine=engine,
                                 device="cpu", devices=["cpu"] * k, **cfg)
        _assert_equal(res, ref, f"{policy}/{engine}: {k} shards")


def test_distinct_devices_run_on_one_thread_each(monkeypatch):
    """Entries that name distinct devices are issued from one host thread
    per device, shards of one device in order; the merge is on mesh[0]."""
    wl, cfg = MATRIX["bfjs"]
    ref = monte_carlo_policy(wl, SEEDS, device="cpu", **cfg)
    spec = sharding.run_shards
    seen = []

    def spy(fn, mesh, items):
        def record(item, dev):
            seen.append((threading.get_ident(), str(dev), list(item)))
            return fn(item, dev)
        return spec(record, mesh, items)

    monkeypatch.setattr(sharding, "run_shards", spy)
    mesh = ("cpu", "cpu:0", "cpu", "cpu:0")
    res = monte_carlo_policy(wl, SEEDS, mesh=mesh, **cfg)
    _assert_equal(res, ref, "cpu / cpu:0 mesh")
    assert [s[2] for s in seen if s[1] == "cpu"] == [[5], [7]]
    assert [s[2] for s in seen if s[1] == "cpu:0"] == [[6], [8]]
    threads = {dev: {t for t, d, _ in seen if d == dev}
               for dev in ("cpu", "cpu:0")}
    assert all(len(t) == 1 for t in threads.values())
    assert threads["cpu"] != threads["cpu:0"]
    assert threading.get_ident() not in threads["cpu"] | threads["cpu:0"]


def test_shard_failure_raises():
    def boom(item, dev):
        if item == 2:
            raise RuntimeError("shard 2 failed")
        return item

    with pytest.raises(RuntimeError, match="shard 2 failed"):
        sharding.run_shards(boom, (torch.device("cpu"),
                                   torch.device("cpu", 0)) * 2,
                            [0, 1, 2, 3])


def test_launch_counters_lose_no_update_across_threads():
    """Shards on distinct cards count their launches from their own
    threads: 16 threads x 2000 adds under a short switch interval."""
    import sys
    from repro_torch.kernels.common import LaunchCounter
    counter, threads, n = LaunchCounter(), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [counter.add() for _ in range(n)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == threads * n


# ---------------------------------------------------------------------------
# chunked sweeps over shards: JAX-made streams, resume on another count
# ---------------------------------------------------------------------------
def _j_scalar(key, n):
    return jax.random.uniform(key, (n,), minval=0.05, maxval=0.5)


def _j_vec(key, n):
    return jax.random.uniform(key, (n, 2), minval=0.05, maxval=0.5)


@pytest.mark.parametrize("policy", ("bfjs", "vqs", "vqs-bf", "bfjs-mr"))
def test_chunked_shards_on_jax_streams_equal_jax(policy):
    """JAX-made ensemble streams through the port's chunked sweep on two
    shards equal JAX's chunked sweep on a 1-device mesh on every field
    (bfjs's occupancy within rtol 1e-6: the port sums it in another
    order)."""
    _, cfg = MATRIX[policy]
    cfg = {k: v for k, v in cfg.items() if k != "horizon"}
    R = 2 if policy == "bfjs-mr" else 1
    keys = jax.random.split(jax.random.PRNGKey(5), G)
    js = jax.vmap(lambda k: j_make_streams(
        k, 0.8, 0.05, _j_vec if R == 2 else _j_scalar, L=4, K=cfg["K"],
        A_max=5, horizon=96, num_resources=R))(keys)
    if policy == "bfjs-mr":
        cfg["capacity"] = (1.0, 0.75)
    want = j_rps(js, policy=policy, engine="scan", chunk=32, devices=1,
                 **cfg)
    pst = streams_from_numpy(js.n, js.sizes, js.durs, device="cpu")
    got = result_to_numpy(run_policy_streams(
        pst, policy=policy, engine="scan", chunk=32, devices=["cpu"] * 2,
        **cfg))
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f == "occupancy" and policy == "bfjs":
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("policy", ("bfjs", "vqs-bf"))
def test_checkpoint_on_4_shards_resumes_on_2(policy, tmp_path):
    wl, cfg = MATRIX[policy]
    full = monte_carlo_policy(wl, SEEDS, policy=policy, device="cpu", **cfg)
    d = str(tmp_path)
    part = monte_carlo_policy(wl, SEEDS, policy=policy, device="cpu",
                              devices=["cpu"] * 4, chunk=32,
                              checkpoint_dir=d, stop_after_chunks=1, **cfg)
    assert part.queue_len.shape == (G, 32)
    assert ckpt.list_steps(d) == [1]
    res = monte_carlo_policy(wl, SEEDS, policy=policy, device="cpu",
                             devices=["cpu"] * 2, chunk=32,
                             checkpoint_dir=d, resume=True, **cfg)
    _assert_equal(res, full, f"{policy}: 4-shard checkpoint resumed on 2")
    # and the same checkpoint unsharded
    res1 = monte_carlo_policy(wl, SEEDS, policy=policy, device="cpu",
                              chunk=32, checkpoint_dir=d, resume=True,
                              **cfg)
    _assert_equal(res1, full, f"{policy}: finished sweep, no mesh")


# ---------------------------------------------------------------------------
# mesh resolution and validation
# ---------------------------------------------------------------------------
def test_resolve_mesh_validation():
    assert ENSEMBLE_AXIS == "ensemble"
    assert resolve_mesh() is None
    m = resolve_mesh(devices=["cpu", "cpu"])
    assert m == (torch.device("cpu"),) * 2
    assert resolve_mesh(mesh=m) == m
    assert resolve_mesh(mesh=["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="not both"):
        resolve_mesh(mesh=m, devices=1)
    with pytest.raises(ValueError, match="1-D mesh"):
        resolve_mesh(mesh=[["cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="at least one device"):
        resolve_mesh(devices=[])
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="device list"):
        resolve_mesh(devices=n + 1)
    with pytest.raises(ValueError, match="device list"):
        resolve_mesh(devices=0)


def test_validation_errors():
    wl, cfg = MATRIX["bfjs"]
    with pytest.raises(ValueError, match="not both"):
        monte_carlo_policy(wl, SEEDS, device="cpu", mesh=["cpu"],
                           devices=["cpu"], **cfg)
    for kw in ({}, dict(chunk=32)):
        with pytest.raises(ValueError, match="divide evenly"):
            monte_carlo_policy(wl, SEEDS[:3], device="cpu",
                               devices=["cpu"] * 2, **kw, **cfg)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_monte_carlo(wl, range(6), mesh=resolve_mesh(
            devices=["cpu"] * 4), device="cpu", **cfg)
    one = streams_from_numpy(np.zeros(40), np.zeros((40, 5)),
                             np.ones((40, 4 * 6 + 5)), device="cpu")
    cfg_s = dict(L=4, K=6, Qcap=64, A_max=5)
    with pytest.raises(ValueError, match="chunk"):
        run_policy_streams(one, devices=["cpu"], **cfg_s)
    ens = type(one)(*(None if x is None else x[None].repeat(
        2, *([1] * x.ndim)) for x in one))
    with pytest.raises(ValueError, match="chunk"):
        run_policy_streams(ens, devices=["cpu"] * 2, **cfg_s)
    with pytest.raises(ValueError, match="ensemble-batched"):
        run_chunked(one, chunk=10, mesh=resolve_mesh(devices=["cpu"]),
                    **cfg_s)
    with pytest.raises(ValueError, match="ensemble-batched"):
        run_policy_streams(one, chunk=10, devices=["cpu"], **cfg_s)
    with pytest.raises(ValueError, match="divide evenly"):
        run_policy_streams(ens, chunk=10, devices=["cpu"] * 4, **cfg_s)
    # the reference engine ignores the mesh, as in JAX
    ref = monte_carlo_policy(wl, SEEDS[:3], engine="reference",
                             device="cpu", devices=["cpu"] * 2, **cfg)
    assert ref.queue_len.shape == (3, 96)


# ---------------------------------------------------------------------------
# estimate_capacity
# ---------------------------------------------------------------------------
def test_estimate_capacity_separates_under_from_overprovisioned():
    """A fleet double the offered load keeps a short queue and drops
    nothing; a fleet at a fraction of it saturates."""
    kw = dict(ensembles=3, horizon=600, K=8, Qcap=128, A_max=6,
              device="cpu")
    lam, mean_slots = 0.4, 40.0          # offered capacity-load ~ 4.4
    big = estimate_capacity(10, lam, mean_slots, **kw)
    small = estimate_capacity(2, lam, mean_slots, **kw)
    assert big["truncated"] == 0
    assert big["dropped"] == 0
    assert big["mean_tail_queue"] < 5
    assert small["mean_tail_queue"] > 10 * max(big["mean_tail_queue"], 0.1)


def test_estimate_capacity_reports_launch_fields():
    kw = dict(ensembles=2, horizon=64, K=6, Qcap=64, A_max=5, device="cpu")
    out = estimate_capacity(4, 0.5, 20.0, **kw)
    assert out["devices"] == 1
    # the conftest's REPRO_TUNING_CACHE=off turns the port's cache off too
    assert out["tuned"] == 0 and out["cache_hit"] == 0
    assert out["truncated"] == 0
    assert out["slots_simulated"] == 2 * 64
    sharded = estimate_capacity(4, 0.5, 20.0, devices=["cpu"] * 2, **kw)
    assert sharded == {**out, "devices": 2}
    for engine in ("cuda", "reference"):
        other = estimate_capacity(4, 0.5, 20.0, engine=engine, **kw)
        assert other == {**out, "engine": engine}
    # members are seeded from SeedSequence(seed), not seed + g
    assert estimate_capacity(4, 0.5, 20.0, seed=1, **kw) != out
