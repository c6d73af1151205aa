"""Arch and shape registry, as in ``repro/configs/registry.py``: all ten
archs of the JAX package.  Its ``input_specs`` and ``cell_supported``
are dry-run and TPU tooling and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.models.model import ModelConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "smollm-135m": "smollm_135m",
    "granite-3-2b": "granite_3_2b",
    "gemma-2b": "gemma_2b",
    "internvl2-1b": "internvl2_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "xlstm-350m": "xlstm_350m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

ARCHS = tuple(_MODULES)


def get_arch(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    pat = cfg.block_pattern
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads // 2 if cfg.n_kv_heads < cfg.n_heads else heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=512,
        n_experts=8 if cfg.n_experts else 0, top_k=2 if cfg.top_k else 0,
        attn_window=32 if cfg.attn_window else 0,
    )
