"""The port's checkpoints (repro_torch.checkpoint.ckpt) against the JAX
package's: dtype-exact round trips of engine-carry planes, the atomic
tmp-then-rename layout, typed corruption errors naming the path, rollback
to the newest valid step, the background writer, and directories that
either package wrote read back identically by the other."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as j_ckpt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.engine import PolicyResult  # noqa: E402


def _planes(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "i32": torch.from_numpy(rng.integers(-5, 2 ** 31 - 1, (3, 7),
                                             dtype=np.int32)),
        "f32": torch.from_numpy(rng.standard_normal((4, 5)).astype(
            np.float32)),
        "mask": torch.from_numpy(rng.random(9) < 0.5),
        "scalar": torch.tensor(7, dtype=torch.int32),
    }


def _result(T=12, R=2, seed=1):
    """A PolicyResult with a (T, R) occupancy plane and unset optional
    fields (None leaves are left out of the checkpoint)."""
    rng = np.random.default_rng(seed)
    return PolicyResult(
        torch.from_numpy(rng.integers(0, 9, T, dtype=np.int32)),
        torch.from_numpy(rng.random((T, R)).astype(np.float32) * 4),
        torch.from_numpy(np.cumsum(rng.integers(0, 3, T)).astype(np.int32)),
        torch.tensor(2, dtype=torch.int32), torch.tensor(0, dtype=torch.int32))


def _corrupt(path, mode):
    if mode == "garbage":
        with open(path, "r+b") as f:
            f.seek(0)
            f.write(b"\x00garbage\x00garbage\x00")
    else:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))


def test_round_trip_is_dtype_and_bit_exact(tmp_path):
    """int32, float32 and bool planes, a () counter and a (T, R) occupancy
    plane survive save/restore with dtype and bits intact; keys follow
    the JAX layout (sorted dict keys, NamedTuple fields, tuple indices)."""
    planes, res = _planes(), _result()
    tree = {"planes": planes, "state": (planes["i32"], planes["mask"]),
            "partial": res}
    ckpt.save(str(tmp_path), 4, tree)
    data = ckpt.load_arrays(str(tmp_path), 4)
    assert set(data) == {
        "planes/f32", "planes/i32", "planes/mask", "planes/scalar",
        "state/0", "state/1", "partial/queue_len", "partial/occupancy",
        "partial/departed", "partial/dropped", "partial/truncated"}
    back = ckpt.restore(str(tmp_path), 4, tree)
    assert back["partial"].preempted is None
    assert back["partial"].occupancy.shape == (12, 2)
    for key, want in ckpt._flatten(tree).items():
        got = data[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for a, b in zip(ckpt._flatten(back).values(),
                    ckpt._flatten(tree).values()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    man = ckpt.read_manifest(str(tmp_path), 4)
    assert man["num_arrays"] == 11 and man["step"] == 4
    assert man["total_bytes"] == sum(a.nbytes for a in data.values())


def test_restore_places_on_the_requested_device(tmp_path):
    planes = _planes()
    ckpt.save(str(tmp_path), 1, planes)
    like = {k: np.zeros(1) for k in planes}  # structure only
    back = ckpt.restore(str(tmp_path), 1, like, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in back.values())
    np.testing.assert_array_equal(back["i32"].numpy(), planes["i32"].numpy())
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), 1, {"nope": torch.zeros(1)})


def test_atomic_layout_leaves_no_tmp(tmp_path):
    ckpt.save(str(tmp_path), 3, {"x": torch.arange(4, dtype=torch.int32)})
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "arrays.npz", "manifest.json"]
    # a crashed save's .tmp directory is never listed as a step
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.list_steps(str(tmp_path)) == [3]
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("mode", ["garbage", "truncate"])
def test_corrupt_arrays_raise_typed_error_naming_path(tmp_path, mode):
    ckpt.save(str(tmp_path), 1, {"x": torch.arange(5)})
    victim = tmp_path / "step_00000001" / "arrays.npz"
    _corrupt(victim, mode)
    with pytest.raises(ckpt.CheckpointCorruptError) as e:
        ckpt.load_arrays(str(tmp_path), 1)
    assert str(victim) in str(e.value) and e.value.path == str(victim)
    # without the checksum the damage still surfaces as the typed error
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_arrays(str(tmp_path), 1, verify=False)


def test_corrupt_manifest_raises_typed_error(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.arange(5)})
    man = tmp_path / "step_00000001" / "manifest.json"
    man.write_text("{not json")
    with pytest.raises(ckpt.CheckpointCorruptError) as e:
        ckpt.read_manifest(str(tmp_path), 1)
    assert str(man) in str(e.value)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_step(str(tmp_path), 1)


def test_latest_valid_step_walks_back(tmp_path):
    for step in (1, 2, 3):
        ckpt.save(str(tmp_path), step, {"x": torch.arange(step)})
    _corrupt(tmp_path / "step_00000003" / "arrays.npz", "garbage")
    _corrupt(tmp_path / "step_00000002" / "arrays.npz", "truncate")
    assert ckpt.latest_valid_step(str(tmp_path)) == (1, [3, 2])
    _corrupt(tmp_path / "step_00000001" / "arrays.npz", "garbage")
    assert ckpt.latest_valid_step(str(tmp_path)) == (None, [3, 2, 1])


def test_async_checkpointer_copies_on_the_caller_thread(tmp_path,
                                                       monkeypatch):
    """``save`` returns after the host copy: mutating the source tensor in
    place right away (as an engine writes its carry) never reaches the
    bytes the background thread writes — here held back until after the
    mutation."""
    import threading
    mutated = threading.Event()
    real_save = ckpt.save

    def gated_save(*args, **kwargs):
        assert mutated.wait(30)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save", gated_save)
    src = torch.arange(1 << 16, dtype=torch.int32)
    want = src.clone()
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(1, {"carry": src, "nothing": None})
    src.mul_(-1)
    src[::3] = 12345
    mutated.set()
    saver.wait()
    got = ckpt.load_arrays(str(tmp_path), 1)
    assert set(got) == {"carry"}
    np.testing.assert_array_equal(got["carry"], want.numpy())


def test_async_checkpointer_gc_and_error_surfacing(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        saver.save(step, {"x": torch.full((3,), step)}, extra={"s": step})
    saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    assert ckpt.read_manifest(str(tmp_path), 4)["extra"] == {"s": 4}
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = ckpt.AsyncCheckpointer(str(blocker))
    bad.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is surfaced once


def test_directories_cross_between_the_packages(tmp_path):
    """A step the JAX package's ``ckpt.save`` wrote reads back through the
    port's ``load_arrays`` key for key and bit for bit, with a manifest the
    port verifies — and a step the port wrote reads back through JAX's."""
    planes = _planes(3)
    res = _result(seed=4)
    j_tree = {"planes": {k: jnp.asarray(v.numpy()) for k, v in
                         planes.items()},
              "state": (jnp.asarray(planes["f32"].numpy()),
                        jnp.asarray(planes["mask"].numpy())),
              "partial": {f: jnp.asarray(getattr(res, f).numpy())
                          for f in ("queue_len", "occupancy", "departed",
                                    "dropped", "truncated")}}
    p_tree = {"planes": planes, "state": (planes["f32"], planes["mask"]),
              "partial": res}
    j_dir, p_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_ckpt.save(j_dir, 2, j_tree, extra={"who": "jax"})
    ckpt.save(p_dir, 2, p_tree, extra={"who": "port"})
    for writer, reader_load, reader_man in (
            (j_dir, ckpt.load_arrays, ckpt.read_manifest),
            (p_dir, j_ckpt.load_arrays, j_ckpt.read_manifest)):
        got = reader_load(writer, 2)
        want = (j_ckpt.load_arrays if reader_load is ckpt.load_arrays
                else ckpt.load_arrays)(writer, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        man = reader_man(writer, 2)
        with open(os.path.join(writer, "step_00000002",
                               "manifest.json")) as f:
            assert json.load(f) == man
    j_data, p_data = ckpt.load_arrays(j_dir, 2), ckpt.load_arrays(p_dir, 2)
    assert sorted(j_data) == sorted(p_data)
    for k in j_data:
        assert j_data[k].dtype == p_data[k].dtype, k
        np.testing.assert_array_equal(j_data[k], p_data[k], err_msg=k)
    assert set(ckpt.read_manifest(j_dir, 2)) == set(
        ckpt.read_manifest(p_dir, 2))
    assert ckpt.latest_valid_step(j_dir) == (2, [])
    assert j_ckpt.latest_valid_step(p_dir) == (2, [])
