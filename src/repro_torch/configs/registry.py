"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).

This slice of the port registers the dense decoder of its main path,
``qwen2-7b`` (and its ``qwen2-smoke`` width); the other architectures of
``repro.configs.registry`` come with the blocks they need (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen2_7b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-7b": qwen2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (this slice registers "
            f"{ARCH_IDS}; the other architectures come with their blocks, "
            f"ROADMAP A6)")
    cfg = _MODULES[arch].SMOKE if smoke else _MODULES[arch].CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
