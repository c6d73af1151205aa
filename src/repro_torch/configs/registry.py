"""Arch and shape registry, as in ``repro/configs/registry.py``: all ten
archs of the JAX package, ``cell_supported`` (which cells the dry run
skips) and ``input_specs`` (each cell's model inputs as stand-ins with
no values, in the JAX package's shapes and dtypes).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

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


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k only runs on sub-quadratic archs (see DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k dense-KV decode is skipped"
    return True, ""


def input_specs(arch, shape_name, *, dtype=torch.bfloat16,
                device="meta") -> dict:
    """Stand-ins with no values for every model input of this cell (an
    arch and a shape by name, or their configs), in the JAX package's
    shapes and dtypes: meta tensors, or fake ones under a
    ``FakeTensorMode``.

    train/prefill: full-sequence inputs. decode: one new token per sequence
    (the KV/recurrent-state cache is ``serve.decode.abstract_cache``)."""
    cfg = arch if isinstance(arch, ModelConfig) else get_arch(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else get_shape(shape_name))
    b, s = shape.global_batch, shape.seq_len
    t = 1 if shape.kind == "decode" else s
    empty = lambda shp, dt: torch.empty(shp, dtype=dt, device=device)
    i32 = torch.int32
    out = ({"tokens": empty((b, t), i32)} if cfg.uses_tokens
           else {"embeds": empty((b, t, cfg.d_model), dtype)})
    if shape.kind == "train":
        out["labels"] = empty((b, s), i32)
    return out
