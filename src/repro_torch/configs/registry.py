"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).

The port registers the decoders whose blocks it builds, in the order of
``repro.configs.registry``: the hybrid ``recurrentgemma-2b`` (RG-LRU
blocks with local attention), the dense ``qwen2-7b``,
``phi3-mini-3.8b`` and ``deepseek-coder-33b``, ``gemma2-27b``
(local/global attention with softcaps, served by the direct integer
backend), the mixtures of experts ``olmoe-1b-7b`` and ``mixtral-8x7b``,
the attention-free ``rwkv6-7b``, the encoder–decoder
``whisper-large-v3`` and the vision–language ``llama-3.2-vision-90b``
(gated cross-attention layers), each with its smoke width: all ten.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_coder_33b, gemma2_27b,
                                 llama32_vision_90b, mixtral_8x7b,
                                 olmoe_1b_7b, phi3_mini_3_8b, qwen2_7b,
                                 recurrentgemma_2b, rwkv6_7b,
                                 whisper_large_v3)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-large-v3": whisper_large_v3,
    "qwen2-7b": qwen2_7b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "gemma2-27b": gemma2_27b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "rwkv6-7b": rwkv6_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    cfg = _MODULES[arch].SMOKE if smoke else _MODULES[arch].CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic
    archs unless ``include_skipped``."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic \
                    and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out
