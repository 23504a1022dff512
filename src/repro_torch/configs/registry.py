"""Architecture registry of the port (``repro.configs.registry``, cut to the
architectures the port runs).

The port runs the decoder stacks built of GQA attention and a dense (or
no) FFN, and the attention-free Mamba2 stack.  The JAX registry's other
ids need a mixer or FFN the port has not ported yet; they raise
``NotImplementedError`` naming the ROADMAP item that will port them.  An
id neither registry knows raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "llama3-8b": "llama3_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen2-72b": "qwen2_72b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-130m": "mamba2_130m",
}
ARCH_IDS = tuple(_MODULES)

#: JAX-registry ids the port does not run yet -> the ROADMAP item.
UNPORTED = {
    "jamba-1.5-large-398b": "ROADMAP queue 1 item 11e (MoE)",
    "deepseek-v2-lite-16b": "ROADMAP queue 1 items 11d (MLA) and 11e (MoE)",
    "dbrx-132b": "ROADMAP queue 1 item 11e (MoE)",
}


def _module(arch_id: str):
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: {UNPORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).full_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


