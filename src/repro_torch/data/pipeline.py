"""Deterministic, index-addressable data pipeline (the port of
``repro.data.pipeline``; its numpy code is copied, so every batch equals
JAX's bit for bit; the one exception is the key of the ``embeds`` stub,
which JAX cannot make: :func:`batch_for_model`).

Every batch is a pure function of (seed, step, host_shard): no iterator
state, so a resumed or re-sharded run recomputes any step's batch.  The
synthetic stream is a Zipf-ish token process with document boundaries
(labels = next token, loss-masked at document starts).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 0


def _host_rng(cfg: DataConfig, step: int, index: int) -> np.random.Generator:
    key = (cfg.seed << 48) ^ (step << 16) ^ index ^ 0xDA7A
    return np.random.Generator(np.random.Philox(key=key))


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             num_shards: int = 1) -> dict[str, np.ndarray]:
    """The (step, shard)-th batch: tokens/labels (B/num_shards, S)."""
    assert cfg.global_batch % num_shards == 0
    b = cfg.global_batch // num_shards
    rng = _host_rng(cfg, step, shard)
    S = cfg.seq_len
    # Zipf-distributed tokens (heavy head like natural text)
    ranks = rng.zipf(1.3, size=(b, S + 1)).astype(np.int64)
    tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
    # document boundaries: geometric doc lengths -> EOS + loss mask
    eos = rng.random((b, S + 1)) < (1.0 / cfg.mean_doc_len)
    tokens = np.where(eos, cfg.eos_id, tokens)
    x, y = tokens[:, :-1], tokens[:, 1:]
    mask = (y != cfg.eos_id).astype(np.float32)
    return {"tokens": x, "labels": y, "mask": mask}


def batch_for_model(mcfg: ModelConfig, dcfg: DataConfig, step: int,
                    shard: int = 0, num_shards: int = 1) -> dict:
    """Model-ready batch; embeds-mode archs get a deterministic frontend-stub
    projection of the tokens (precomputed frame/patch embeddings)."""
    raw = batch_at(dcfg, step, shard, num_shards)
    if mcfg.input_mode == "tokens":
        return raw
    # frontend stub: fixed random projection of one-hot tokens -> embeddings.
    # JAX keys it with the four words [seed, 0, 0, 0xE5], which numpy's
    # Philox (a two-word key) refuses with a ValueError; the port keys it
    # with the two words that are not zero
    proj_rng = np.random.Generator(np.random.Philox(key=[dcfg.seed, 0xE5]))
    table = proj_rng.standard_normal((dcfg.vocab_size, mcfg.d_model)) * 0.02
    embeds = table[raw["tokens"]].astype(np.float32)
    return {"embeds": embeds, "labels": raw["labels"], "mask": raw["mask"]}


def device_put_batch(batch: dict, device=None) -> dict:
    """The batch's arrays as tensors on ``device`` (``None``: the card),
    dtypes kept (int32 tokens and labels, float32 mask and embeds)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
