"""Architecture registry of the port (``repro.configs.registry``'s
``--arch`` resolution and shape applicability): the JAX registry's ten
ids, each a copy of its config module.  An id the registry does not know
raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, TRAIN_4K, ModelConfig,
                                       ShapeConfig)

_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "dbrx-132b": "dbrx_132b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3-8b": "llama3_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen2-72b": "qwen2_72b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
}
ARCH_IDS = tuple(_MODULES)

_SHAPES = {s.name: s for s in ALL_SHAPES}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return _SHAPES[name]


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k needs sub-quadratic attention: SSM/hybrid stacks or SWA.
    Pure full-attention archs skip it (documented in DESIGN.md)."""
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if supports_long_context(cfg):
        shapes.append(LONG_500K)
    return shapes
