"""The port's shape-keyed tuner and its cache (core/engine/tuning.py): the
six tuning tests of tests/test_sharded_mc.py on the port, and the port's
own cache rules — its own variable and file (``REPRO_TORCH_TUNING_CACHE``,
``~/.cache/repro_torch/sched_tuning.json``), ``off`` when that variable is
``off`` or when it is unset and the JAX package's ``REPRO_TUNING_CACHE``
is ``off`` (the conftest's setting), and the JAX file never read or
written.  Every test that opts in points the variables at ``tmp_path``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (TuningCache, Workload,  # noqa: E402
                                     apply_tuned, autotune,
                                     monte_carlo_policy, run_policy,
                                     run_policy_streams, shape_key,
                                     stream_policy, tuning_enabled)
from repro_torch.core.engine import tuning  # noqa: E402
from repro_torch.core.engine.streaming import \
    iter_stream_chunks  # noqa: E402
from repro_torch.serving.engine import estimate_capacity  # noqa: E402

OWN, JAX = "REPRO_TORCH_TUNING_CACHE", "REPRO_TUNING_CACHE"


def _sampler(gen, n, device):
    return torch.rand(n, generator=gen, device=device) * 0.45 + 0.05


WL = Workload(lam=1.2, mu=0.05, sampler=_sampler)
CFG = dict(L=4, K=6, Qcap=64, A_max=5, horizon=96, device="cpu")


def _equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """The port's cache at tmp_path/c.json, the JAX variable at a file that
    must never appear."""
    path = tmp_path / "c.json"
    monkeypatch.setenv(OWN, str(path))
    monkeypatch.setenv(JAX, str(tmp_path / "jax.json"))
    yield path
    assert not (tmp_path / "jax.json").exists()


def test_conftest_keeps_the_suite_hermetic():
    assert os.environ.get(JAX) == "off"
    if OWN not in os.environ:
        assert not tuning_enabled() and tuning.cache_path() is None


def test_cache_round_trip(cache_file, tmp_path):
    assert tuning_enabled()
    key = shape_key("bfjs", "scan", L=4, K=8, R=1, Qcap=64, A_max=6,
                    backend="cpu")
    assert key == "bfjs|scan|cpu|L=4|K=8|R=1|Qcap=64|A_max=6"
    TuningCache().put(key, {"work_steps": 5})
    assert TuningCache().get(key)["work_steps"] == 5
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    with open(cache_file) as f:
        data = json.load(f)
    assert data["schema"] == tuning.SCHEMA
    assert data["entries"][key]["work_steps"] == 5


@pytest.mark.parametrize("own,jax_var,enabled", [
    ("off", None, False),            # the port's own switch
    ("OFF", "/nowhere/j.json", False),
    (None, "off", False),            # unset: the JAX switch turns it off
    ("", "off", False),
    ("PATH", "off", True),           # a path of its own wins
    (None, None, True),              # the default file
    (None, "PATH", True),            # a JAX path is never the port's
])
def test_the_shared_off_rule(tmp_path, monkeypatch, own, jax_var, enabled):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for var, value in ((OWN, own), (JAX, jax_var)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value.replace(
                "PATH", str(tmp_path / f"{var}.json")))
    assert tuning_enabled() is enabled
    if not enabled:
        assert tuning.cache_path() is None
        return
    want = (tmp_path / f"{OWN}.json") if own == "PATH" else \
        tmp_path / "home" / ".cache" / "repro_torch" / "sched_tuning.json"
    assert tuning.cache_path() == str(want)
    TuningCache().put("k", {"work_steps": 2})
    assert want.exists() and not (tmp_path / f"{JAX}.json").exists()


def test_cache_off_disables_everything(monkeypatch):
    monkeypatch.setenv(OWN, "off")
    assert not tuning_enabled()
    cfg = dict(L=4, K=8, Qcap=64, A_max=6)
    assert apply_tuned("bfjs", "scan", cfg) == {"tuned": 0, "cache_hit": 0}
    assert "work_steps" not in cfg
    with pytest.raises(ValueError, match="disabled"):
        autotune(WL, [0, 1], policy="bfjs", engine="scan", **CFG)


def test_corrupt_and_stale_caches_ignored(cache_file):
    cache_file.write_text("{definitely not json")
    with pytest.warns(UserWarning, match="corrupt"):
        assert TuningCache().load() == {}
    cache_file.write_text(json.dumps(
        {"schema": "tuning.v0", "entries": {"k": {"work_steps": 1}}}))
    with pytest.warns(UserWarning, match="schema"):
        assert TuningCache().load() == {}
    with pytest.warns(UserWarning, match="schema"):
        TuningCache().put("k", {"work_steps": 3})
    assert TuningCache().get("k")["work_steps"] == 3


def test_apply_tuned_fill_semantics(cache_file):
    shape = dict(L=4, K=8, R=1, Qcap=64, A_max=6)
    for engine in ("scan", "cuda"):
        TuningCache().put(shape_key("bfjs", engine, backend="cpu", **shape),
                          {"work_steps": 4, "window": 48})
    for engine in ("scan", "cuda"):
        cfg = dict(L=4, K=8, Qcap=64, A_max=6, device="cpu")
        assert apply_tuned("bfjs", engine, cfg) \
            == {"tuned": 1, "cache_hit": 1}
        # work_steps only: the CUDA kernels take any window for free
        assert cfg["work_steps"] == 4 and "window" not in cfg
    # an explicit value always wins over the cache
    cfg = dict(L=4, K=8, Qcap=64, A_max=6, work_steps=9, device="cpu")
    assert apply_tuned("bfjs", "scan", cfg) == {"tuned": 0, "cache_hit": 1}
    assert cfg["work_steps"] == 9
    # reference has no launch knobs: bypassed entirely
    cfg = dict(L=4, K=8, Qcap=64, A_max=6, device="cpu")
    assert apply_tuned("bfjs", "reference", cfg) \
        == {"tuned": 0, "cache_hit": 0}
    # another shape, or the card's backend (the default device), misses
    for cfg in (dict(L=16, K=8, Qcap=64, A_max=6, device="cpu"),
                dict(L=4, K=8, Qcap=64, A_max=6)):
        assert apply_tuned("bfjs", "scan", cfg) \
            == {"tuned": 0, "cache_hit": 0}
    assert apply_tuned("bfjs", "scan", dict(L=4, K=8, Qcap=64, A_max=6),
                       backend="cpu") == {"tuned": 1, "cache_hit": 1}


def test_autotune_caches_verified_winner_end_to_end(cache_file,
                                                    monkeypatch):
    seeds = [3, 4]
    out = autotune(WL, seeds, policy="bfjs", engine="scan",
                   work_steps_grid=(1, 3, 24), rounds=1, **CFG)
    assert out["key"] == shape_key("bfjs", "scan", L=4, K=6, R=1, Qcap=64,
                                   A_max=5, backend="cpu")
    assert out["candidates"] + out["rejected"] == 3
    assert out["candidates"] >= 1      # 24 steps truncate nothing here
    entry = TuningCache().get(out["key"])
    assert entry is not None and entry["speedup"] >= 1.0
    assert entry["work_steps"] in (None, 1, 3, 24) and "window" not in entry
    cfg = dict(CFG)
    assert apply_tuned("bfjs", "scan", cfg)["cache_hit"] == 1
    # the cached winner reproduces the default trajectory bit for bit when
    # injected by the normal entry points
    tuned = monte_carlo_policy(WL, seeds, policy="bfjs", engine="scan",
                               **CFG)
    cap = estimate_capacity(4, 1.2, 20.0, ensembles=2, horizon=96, K=6,
                            Qcap=64, A_max=5, device="cpu")
    assert cap["cache_hit"] == 1
    monkeypatch.setenv(OWN, "off")
    default = monte_carlo_policy(WL, seeds, policy="bfjs", engine="scan",
                                 **CFG)
    _equal(tuned, default)


def test_autotune_rejects_candidates_that_diverge(cache_file):
    """At load well over 1 a one-step work list truncates: rejected, and
    never cached."""
    wl = Workload(lam=6.0, mu=0.05, sampler=_sampler)
    out = autotune(wl, [0, 1], policy="bfjs", engine="scan",
                   work_steps_grid=(1, 64), rounds=1, **CFG)
    assert out["rejected"] >= 1 and out["work_steps"] in (None, 64)


def test_autotune_refusals(cache_file):
    with pytest.raises(ValueError, match="no launch knobs"):
        autotune(WL, [0, 1], policy="bfjs", engine="reference", **CFG)
    with pytest.raises(ValueError, match="plain version"):
        autotune(WL, [0, 1], policy="bfjs", engine="cuda", **CFG)
    out = autotune(WL, [0, 1], policy="vqs", engine="cuda", J=3,
                   work_steps_grid=(16,), rounds=1, allow_plain=True, **CFG)
    assert out["key"].startswith("vqs|cuda|cpu|")


def test_entry_points_consult_the_cache(cache_file, monkeypatch):
    """run_policy, run_policy_streams, monte_carlo_policy and
    stream_policy each fill an unset work_steps from the cache entry of
    their shape and backend."""
    seen = []
    real = tuning.TuningCache.get

    def spy(self, key):
        entry = real(self, key)
        seen.append((key, entry))
        return entry

    monkeypatch.setattr(tuning.TuningCache, "get", spy)
    key = shape_key("bfjs", "scan", L=4, K=6, R=1, Qcap=64, A_max=5,
                    backend="cpu")
    TuningCache().put(key, {"work_steps": 24})
    want = monte_carlo_policy(WL, [0], work_steps=24, **CFG)
    seen.clear()
    got = run_policy(WL, 0, **CFG)
    np.testing.assert_array_equal(got.queue_len.numpy(),
                                  want.queue_len[0].numpy())
    from repro_torch.core.engine import ensemble_streams
    st = ensemble_streams([0], 1.2, 0.05, _sampler, L=4, K=6, A_max=5,
                          horizon=96, device="cpu")
    cfg = dict(L=4, K=6, Qcap=64, A_max=5)
    run_policy_streams(st, **cfg)
    stream_policy(iter_stream_chunks(st, 32), device="cpu", **cfg)
    monte_carlo_policy(WL, [0], **CFG)
    assert [k for k, _ in seen] == [key] * 4
    assert all(e == {"work_steps": 24} for _, e in seen)


def test_a_mesh_keys_the_cache_by_its_device_type(cache_file):
    """With mesh=/devices= and no device=, monte_carlo_policy,
    run_policy_streams and estimate_capacity look up the entry of the
    mesh's device type, not the card's."""
    cfg = {k: v for k, v in CFG.items() if k != "device"}
    shape = dict(L=4, K=6, R=1, Qcap=64, A_max=5)
    TuningCache().put(shape_key("bfjs", "scan", backend="cpu", **shape),
                      {"work_steps": 1})
    want = monte_carlo_policy(WL, [0, 1], work_steps=1, **CFG)
    assert int(want.truncated.sum()) > 0   # the cpu entry changes the run
    got = monte_carlo_policy(WL, [0, 1], devices=["cpu"] * 2, **cfg)
    _equal(got, want)
    from repro_torch.core.engine import ensemble_streams
    st = ensemble_streams([0, 1], 1.2, 0.05, _sampler, L=4, K=6, A_max=5,
                          horizon=96, device="cpu")
    sharded = run_policy_streams(st, chunk=48, devices=["cpu"] * 2,
                                 **{k: v for k, v in cfg.items()
                                    if k != "horizon"})
    _equal(sharded, want)
    cap = estimate_capacity(4, 1.2, 20.0, ensembles=2, horizon=96, K=6,
                            Qcap=64, A_max=5, devices=["cpu"] * 2)
    assert (cap["devices"], cap["cache_hit"], cap["tuned"]) == (2, 1, 1)
