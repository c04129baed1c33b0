"""--arch registry: every assigned architecture + the paper's own workload.

Port of `repro/configs/registry.py`.  The reference loads the arch modules
by name through `importlib`; the port imports the eleven modules statically
and keeps a dict from arch id to module, the same ids in the same order.
"""
from __future__ import annotations

from . import (codeqwen15_7b, embedding_paper, grok1_314b,
               llama4_maverick_400b, llama_3_2_vision_90b, musicgen_medium,
               nemotron_4_340b, qwen2_7b, rwkv6_7b, yi_34b, zamba2_2_7b)
from .base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "yi-34b": yi_34b,
    "qwen2-7b": qwen2_7b,
    "nemotron-4-340b": nemotron_4_340b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "musicgen-medium": musicgen_medium,
    "rwkv6-7b": rwkv6_7b,
    "zamba2-2.7b": zamba2_2_7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "grok-1-314b": grok1_314b,
}

EMBEDDING_ARCHS = ("embedding-coil20", "embedding-mnist20k", "embedding-large")

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in EMBEDDING_ARCHS:
        mod = embedding_paper
        return {c.name: c for c in (mod.COIL20, mod.MNIST20K, mod.LARGE)}[arch]
    if arch not in _ARCH_MODULES:
        raise ValueError(
            f"unknown arch {arch!r}; have {sorted(ARCH_IDS + EMBEDDING_ARCHS)}"
        )
    return _ARCH_MODULES[arch].CONFIG


def get_smoke_config(arch: str):
    if arch in EMBEDDING_ARCHS:
        return embedding_paper.smoke_config()
    return _ARCH_MODULES[arch].smoke_config()


def shape_cells(arch: str) -> list[ShapeConfig]:
    """The assigned shape set for an arch, with the long_500k skip rule:
    sub-quadratic archs (ssm/hybrid) run it, pure full-attention archs skip."""
    cfg = get_config(arch)
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if not cfg.full_attention:
        cells.append(SHAPES["long_500k"])
    return cells


def skipped_cells(arch: str) -> list[tuple[ShapeConfig, str]]:
    cfg = get_config(arch)
    if cfg.full_attention:
        return [(
            SHAPES["long_500k"],
            "pure full-attention arch: 512k decode needs sub-quadratic "
            "attention not part of the published config",
        )]
    return []
