"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's: the same numpy Philox streams, so every token, label and
mask is equal bit for bit.  The ``embeds`` stub is the one difference:
JAX keys it with four words, which numpy's two-word Philox refuses, and
the port keys it with the two that are not zero."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import batch_at as j_batch_at  # noqa: E402
from repro.data.pipeline import \
    batch_for_model as j_batch_for_model  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, batch_at,  # noqa: E402
                                       batch_for_model, device_put_batch)
from repro_torch.models.config import ModelConfig  # noqa: E402


def _cfgs(**kw):
    return JDataConfig(**kw), DataConfig(**kw)


@pytest.mark.parametrize("seed,step,shard,num_shards", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 1, 1, 2), (11, 12345, 3, 4),
    (2**10, 2**20, 0, 2)])
def test_batch_at_equals_jax_bit_for_bit(seed, step, shard, num_shards):
    jc, tc = _cfgs(vocab_size=4096, seq_len=48, global_batch=8, seed=seed,
                   mean_doc_len=16)
    got = batch_at(tc, step, shard, num_shards)
    ref = j_batch_at(jc, step, shard, num_shards)
    assert set(got) == set(ref) == {"tokens", "labels", "mask"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])
    assert (got["mask"] == 0).any()     # document boundaries were drawn


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_batch_for_model_tokens_equals_jax(arch):
    jcfg = j_smoke(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jc, tc = _cfgs(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4,
                   seed=5)
    for step in (0, 3):
        got, ref = batch_for_model(tcfg, tc, step), \
            j_batch_for_model(jcfg, jc, step)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_batch_for_model_embeds_stub():
    """JAX's embeds stub raises (numpy's Philox takes a two-word key); the
    port's labels and mask are JAX's, and its embeds are rows of a table
    drawn from ``Philox(key=[seed, 0xE5])`` at JAX's tokens."""
    jcfg = j_smoke("musicgen-medium")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jc, tc = _cfgs(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2,
                   seed=7)
    with pytest.raises(ValueError, match="2 elements"):
        j_batch_for_model(jcfg, jc, 1)
    got = batch_for_model(tcfg, tc, 1)
    raw = j_batch_at(jc, 1)
    assert set(got) == {"embeds", "labels", "mask"}
    np.testing.assert_array_equal(got["labels"], raw["labels"])
    np.testing.assert_array_equal(got["mask"], raw["mask"])
    table = np.random.Generator(np.random.Philox(key=[7, 0xE5])) \
        .standard_normal((jcfg.vocab_size, jcfg.d_model)) * 0.02
    np.testing.assert_array_equal(got["embeds"],
                                  table[raw["tokens"]].astype(np.float32))
    assert got["embeds"].shape == (2, 16, jcfg.d_model)


def test_device_put_batch_keeps_dtypes():
    tc = DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    b = device_put_batch(batch_at(tc, 0), "cpu")
    assert b["tokens"].dtype == torch.int32
    assert b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  batch_at(tc, 0)["tokens"])
