"""The LM zoo's model, as in ``repro/models/model.py``: one
``ModelConfig`` for every arch, layers grouped into a repeating block
pattern whose per-period params are stacked on a leading axis.

Only the ``"attn"`` block kind is ported (the dense archs); the others
(``attn_moe``, ``attn_local``, ``rglru``, ``mlstm``, ``slstm``) and the
remainder blocks of mixed patterns raise ``NotImplementedError``.
Params are a dict of tensors with the JAX package's tree, keys and
layout (``wq`` is [d, H*hd] and is applied as ``x @ w``), so
:func:`params_from_numpy` carries the JAX package's params across with
no transpose.

``forward`` is the prefill forward (no labels), or the training loss
(labels): the JAX package's ``lax.scan`` over periods is a Python loop
over the stacked params, and its ``jax.checkpoint`` policies are
``torch.utils.checkpoint`` forms (see :func:`forward`).  Its sharding
annotations (``maybe_shard``) have no counterpart on one card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.models.attention import attention_block

PORTED_KINDS = ("attn",)
REMAT = ("none", "full", "dots", "save_outs")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp_kind: str = "swiglu"    # swiglu | geglu
    n_experts: int = 0
    top_k: int = 0
    block_pattern: tuple = ("attn",)
    attn_window: int = 0        # sliding window for "attn_local" blocks
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False   # gemma-style sqrt(d) scaling
    frontend: str = ""          # "" | "vit_stub" | "encodec_stub"
    sub_quadratic: bool = False # may run the long_500k decode cell
    source: str = ""            # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder(self) -> tuple:
        r = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    @property
    def mlstm_d_in(self) -> int:
        return 2 * self.d_model

    @property
    def uses_tokens(self) -> bool:
        return self.frontend == ""


def check_config(cfg: ModelConfig) -> None:
    """Raise for what this slice does not port: block kinds other than
    ``"attn"``, and remainder blocks (which only mixed patterns have)."""
    for kind in cfg.block_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} (MoE, local attention, RG-LRU, "
                "xLSTM) is ROADMAP Queue 1 item 16, not yet ported")
    if cfg.remainder:
        raise NotImplementedError(
            f"{cfg.name}: remainder blocks {cfg.remainder} belong to mixed "
            "block patterns, ROADMAP Queue 1 item 16, not yet ported")


# ----------------------------------------------------------------------
# Parameter construction
# ----------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Shapes of one ``"attn"`` block's params."""
    d = cfg.d_model
    hd = cfg.hd
    return {
        "norm1": (d,), "norm2": (d,),
        "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
        "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
        "w_down": (cfg.d_ff, d),
    }


def param_count(cfg: ModelConfig) -> int:
    check_config(cfg)
    pv, d = cfg.padded_vocab, cfg.d_model
    tables = (1 if cfg.tie_embeddings else 2) * pv * d
    block = sum(math.prod(s) for s in _block_shapes(cfg).values())
    return tables + d + cfg.n_layers * block


def _normal(shape, std, generator, dtype, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _init_block(out: Dict[str, torch.Tensor], cfg: ModelConfig, generator,
                dtype, device) -> None:
    """Fill one block's params (the slices ``out`` holds) in the JAX
    package's scheme: zero norms, normal * 1/sqrt(fan_in) weights."""
    for name, shape in sorted(_block_shapes(cfg).items()):
        if name.startswith("norm"):
            out[name].zero_()
        else:
            std = 1.0 / math.sqrt(max(shape[-2], 1))
            out[name].copy_(_normal(shape, std, generator, dtype, device))


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Random params with the JAX package's tree and init scheme, drawn
    from ``generator`` (whose device must be ``device``; default: the
    card).  The numbers are not those of jax.random for the same seed."""
    check_config(cfg)
    device = torch.device("cuda" if device is None else device)
    pv, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": _normal((pv, d), 0.02, generator, dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal((pv, d), 0.02, generator, dtype, device)
    period: Dict[str, Any] = {}
    for j, kind in enumerate(cfg.block_pattern):
        stacked = {n: torch.empty((cfg.n_periods,) + s, dtype=dtype,
                                  device=device)
                   for n, s in _block_shapes(cfg).items()}
        # One period at a time: the f32 draw is one period's size.
        for p in range(cfg.n_periods):
            _init_block({n: t[p] for n, t in stacked.items()}, cfg,
                        generator, dtype, device)
        period[f"{j}_{kind}"] = stacked
    params["period"] = period
    return params


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's param pytree, as numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``), as this package's dict of tensors on
    ``device``; ``dtype`` casts every leaf.  bf16 goes through f32,
    which holds it exactly."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`: numpy arrays on the
    host, bf16 as ``ml_dtypes.bfloat16``."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def _checkpointed(fn, *args, **kw):
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def _apply_block(x, bp, cfg: ModelConfig, positions, plain: bool = False,
                 save_outs: bool = False):
    """One ``"attn"`` block.  ``save_outs``: each half under its own
    checkpoint, so the backward keeps each half's input (x, and x plus
    the attention output) and recomputes the rest: the residuals of
    ``save_only_these_names("blk_attn_out", "blk_mlp_out")``, held as
    the sums the next half reads."""
    def attn(x):
        return attention_block(L.rms_norm(x, bp["norm1"]), bp, cfg,
                               positions, plain=plain)

    def mlp(x):
        return L.gated_mlp(L.rms_norm(x, bp["norm2"]), bp["w_gate"],
                           bp["w_up"], bp["w_down"], cfg.mlp_kind)

    if save_outs:
        x = x + _checkpointed(attn, x)
        return x + _checkpointed(mlp, x)
    x = x + attn(x)
    return x + mlp(x)


def _save_dots(ctx, op, *args, **kw):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of the
    products without batch dims (``x @ w``, which autograd sees as
    ``mm``); recompute the rest, attention's batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def forward(params, cfg: ModelConfig, tokens=None, embeds=None,
            labels=None, remat: str = "none"):
    """The mean cross entropy if ``labels`` [B, T] are given, else the
    final hidden states [B, T, d] of the prefill forward.

    tokens: int [B, T] (token archs); embeds: [B, T, d] (stub frontends).
    Without labels every attention layer runs through
    ``kernels.ops.flash_attention_op`` (forward only); with labels
    through the JAX package's plain attention, which autograd
    differentiates (``attention_block``'s ``plain``).

    ``remat``, as the JAX package's ``jax.checkpoint`` of each period:
    ``"none"``; ``"full"`` (``torch.utils.checkpoint`` around each
    period: the backward keeps only each period's input); ``"dots"``
    (the same with a selective policy that keeps the ``x @ w`` outputs,
    see :func:`_save_dots`); ``"save_outs"`` (each block's attention and
    MLP outputs, see :func:`_apply_block`).  All four give the same
    numbers; they trade memory for recompute.
    """
    check_config(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
    plain = labels is not None
    if embeds is None:
        x = L.embed(tokens, params["embed"], cfg.embed_scale)
    else:
        x = embeds.to(params["embed"].dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device)[None].expand(b, t)

    def period_body(xc, p):
        for j, kind in enumerate(cfg.block_pattern):
            stacked = params["period"][f"{j}_{kind}"]
            xc = _apply_block(xc, {n: w[p] for n, w in stacked.items()},
                              cfg, positions, plain=plain,
                              save_outs=remat == "save_outs")
        return xc

    for p in range(cfg.n_periods):
        if remat == "full":
            x = _checkpointed(period_body, x, p)
        elif remat == "dots":
            x = _checkpointed(period_body, x, p, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
        else:
            x = period_body(x, p)
    x = L.rms_norm(x, params["final_norm"])
    if labels is None:
        return x
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.logits_and_xent(x, table, labels)
