"""Architecture registry of the port (``repro.configs.registry``'s
``--arch`` resolution): the JAX registry's ten ids, each a copy of its
config module.  An id the registry does not know raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

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


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


