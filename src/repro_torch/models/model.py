"""The LM zoo's model, as in ``repro/models/model.py``: one
``ModelConfig`` for every arch, layers grouped into a repeating block
pattern whose per-period params are stacked on a leading axis, and the
remainder blocks (``n_layers`` not a multiple of the pattern) unstacked
under ``params["rem"]``.

Block kinds: ``"attn"`` (dense), ``"attn_local"`` (a sliding window),
``"attn_moe"`` (attention and a routed MoE FFN, ``models/moe.py``),
``"rglru"`` (``models/rglru.py``), ``"mlstm"`` and ``"slstm"``
(``models/xlstm.py``).  Params are a dict of tensors with the JAX
package's tree, keys and layout (``wq`` is [d, H*hd] and is applied as
``x @ w``), so :func:`params_from_numpy` carries the JAX package's
params across with no transpose.

``forward`` is the prefill forward (no labels), or the training loss
(labels): the JAX package's ``lax.scan`` over periods is a Python loop
over the stacked params, and its ``jax.checkpoint`` policies are
``torch.utils.checkpoint`` forms (see :func:`forward`).  Its sharding
annotations (``maybe_shard``, ``models/sharding.py``) apply under an
active mesh and are the identity without one; :func:`build_param_specs`
gives the params' specs and :func:`abstract_params` their stand-ins for
the dry run (``launch/dryrun.py``).
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
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import rglru_block
from repro_torch.models.sharding import P, maybe_shard
from repro_torch.models.xlstm import mlstm_block, slstm_block

ATTN_KINDS = ("attn", "attn_local", "attn_moe")
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


# ----------------------------------------------------------------------
# Parameter construction
# ----------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig, kind: str) -> Dict[str, tuple]:
    """Shapes of one block's params."""
    d = cfg.d_model
    hd = cfg.hd
    if kind in ATTN_KINDS:
        s: Dict[str, tuple] = {
            "norm1": (d,), "norm2": (d,),
            "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
        }
        if kind == "attn_moe":
            s.update(router=(d, cfg.n_experts),
                     w_gate=(cfg.n_experts, d, cfg.d_ff),
                     w_up=(cfg.n_experts, d, cfg.d_ff),
                     w_down=(cfg.n_experts, cfg.d_ff, d))
        else:
            s.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                     w_down=(cfg.d_ff, d))
        return s
    if kind == "rglru":
        dr = d  # lru width = d_model (recurrentgemma-2b)
        return {
            "norm1": (d,), "norm2": (d,),
            "w_y": (d, dr), "w_x": (d, dr), "conv_w": (4, dr),
            "w_a": (dr, dr), "b_a": (dr,), "w_i": (dr, dr), "b_i": (dr,),
            "lam": (dr,), "w_o": (dr, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d),
        }
    if kind == "mlstm":
        di = cfg.mlstm_d_in
        h = cfg.n_heads
        return {
            "norm1": (d,),
            "w_up_x": (d, di), "w_up_z": (d, di),
            "w_q": (di, di), "w_k": (di, di), "w_v": (di, di),
            "w_f": (di, h), "b_f": (h,), "w_i": (di, h), "b_i": (h,),
            "w_down": (di, d),
        }
    if kind == "slstm":
        h = cfg.n_heads
        dh = d // h
        ff = int(round(d * 4 / 3))
        return {
            "norm1": (d,),
            "w_zifo": (d, 4 * d), "r_kernel": (h, dh, 4 * dh),
            "w_proj": (d, d),
            "w_ff_gate": (d, ff), "w_ff_up": (d, ff), "w_ff_down": (ff, d),
        }
    raise ValueError(kind)


def _block_specs(cfg: ModelConfig, kind: str,
                 model_shards: int) -> Dict[str, P]:
    """One block's param specs, as the JAX package's: attention's heads
    and the MLP's hidden dim over 'model' where they divide, the MoE
    experts over 'model', RG-LRU's width over 'model'; the xLSTM kernels
    replicate."""
    def div(n):
        return n % model_shards == 0
    out: Dict[str, P] = {}
    for name, shape in _block_shapes(cfg, kind).items():
        spec = P(*([None] * len(shape)))
        if kind in ATTN_KINDS:
            if name in ("wq",) and div(cfg.n_heads):
                spec = P(None, "model")
            elif name in ("wk", "wv") and div(cfg.n_kv_heads):
                spec = P(None, "model")
            elif name == "wo" and div(cfg.n_heads):
                spec = P("model", None)
            elif name == "router":
                spec = P(None, None)
            elif name in ("w_gate", "w_up"):
                spec = (P("model", None, None) if kind == "attn_moe"
                        else (P(None, "model") if div(cfg.d_ff) else spec))
            elif name == "w_down":
                spec = (P("model", None, None) if kind == "attn_moe"
                        else (P("model", None) if div(cfg.d_ff) else spec))
        elif kind == "rglru":
            dr = cfg.d_model
            if name in ("w_y", "w_x", "w_a", "w_i") and div(dr):
                spec = P(None, "model")
            elif name in ("b_a", "b_i", "lam") and div(dr):
                spec = P("model")
            elif name == "conv_w" and div(dr):
                spec = P(None, "model")
            elif name == "w_o" and div(dr):
                spec = P("model", None)
            elif name in ("w_gate", "w_up") and div(cfg.d_ff):
                spec = P(None, "model")
            elif name == "w_down" and div(cfg.d_ff):
                spec = P("model", None)
        out[name] = spec
    return out


def build_param_specs(cfg: ModelConfig, model_shards: int = 16):
    """The params' spec tree (``models/sharding.P`` leaves), leaf by leaf
    the JAX package's: the tables over 'model' on the vocab where it
    divides, each period leaf with a replicated leading period axis."""
    vocab_ok = cfg.padded_vocab % model_shards == 0
    emb = P("model", None) if vocab_ok else P(None, None)
    specs: Dict[str, Any] = {"embed": emb, "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["unembed"] = emb
    specs["period"] = {
        f"{j}_{kind}": {n: P(None, *s) for n, s in
                        _block_specs(cfg, kind, model_shards).items()}
        for j, kind in enumerate(cfg.block_pattern)}
    if cfg.remainder:
        specs["rem"] = {f"{j}_{kind}": _block_specs(cfg, kind, model_shards)
                        for j, kind in enumerate(cfg.remainder)}
    return specs


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16,
                    device="meta") -> Dict[str, Any]:
    """The params' tree with their shapes and dtype and no values: meta
    tensors, or fake ones when called under a ``FakeTensorMode`` with a
    real device (the dry run's stand-ins; nothing is allocated)."""
    empty = lambda shape: torch.empty(shape, dtype=dtype, device=device)
    pv, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {"embed": empty((pv, d)),
                              "final_norm": empty((d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = empty((pv, d))
    params["period"] = {
        f"{j}_{kind}": {n: empty((cfg.n_periods,) + s)
                        for n, s in _block_shapes(cfg, kind).items()}
        for j, kind in enumerate(cfg.block_pattern)}
    if cfg.remainder:
        params["rem"] = {f"{j}_{kind}": {n: empty(s) for n, s in
                                         _block_shapes(cfg, kind).items()}
                         for j, kind in enumerate(cfg.remainder)}
    return params


def _tree_shapes(cfg: ModelConfig):
    """(shape, count) of every param leaf: the tables, the period blocks
    (n_periods each) and the remainder blocks (one each), with each
    leaf's name."""
    pv, d = cfg.padded_vocab, cfg.d_model
    out = [("embed", (pv, d), 1), ("final_norm", (d,), 1)]
    if not cfg.tie_embeddings:
        out.append(("unembed", (pv, d), 1))
    for kinds, n in ((cfg.block_pattern, cfg.n_periods),
                     (cfg.remainder, 1)):
        for kind in kinds:
            out += [(name, s, n) for name, s in
                    _block_shapes(cfg, kind).items()]
    return out


def param_count(cfg: ModelConfig) -> int:
    return sum(n * math.prod(s) for _, s, n in _tree_shapes(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: params touched per token (for 6*N_active*D roofline).  As the
    JAX package counts them: every leaf whose name holds ``w_gate``,
    ``w_up`` or ``w_down`` is an expert's, scaled by top_k / n_experts."""
    total = param_count(cfg)
    if cfg.n_experts and cfg.top_k:
        expert = sum(n * math.prod(s) for name, s, n in _tree_shapes(cfg)
                     if any(w in name for w in ("w_gate", "w_up", "w_down")))
        total = total - expert + int(expert * cfg.top_k / cfg.n_experts)
    return total


def _normal(shape, std, generator, dtype, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std).to(dtype)


def _init_block(out: Dict[str, torch.Tensor], cfg: ModelConfig, kind: str,
                generator, dtype, device) -> None:
    """Fill one block's params (the tensors or slices ``out`` holds) in
    the JAX package's scheme: zero norms and biases, RG-LRU's ``lam`` a
    linspace over [2.2, 6.9], normal * 1/sqrt(fan_in) weights.  Every
    ``b_*`` is zero, the mLSTM forget bias ``b_f`` included: the JAX
    package's ``b_f = 3.0`` branch comes after ``startswith("b_")`` and
    is never reached."""
    for name, shape in sorted(_block_shapes(cfg, kind).items()):
        if name.startswith("norm") or name.startswith("b_"):
            out[name].zero_()
        elif name == "lam":
            out[name].copy_(torch.linspace(2.2, 6.9, shape[0],
                                           dtype=torch.float32))
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            out[name].copy_(_normal(shape, std, generator, dtype, device))


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Random params with the JAX package's tree and init scheme, drawn
    from ``generator`` (whose device must be ``device``; default: the
    card).  The numbers are not those of jax.random for the same seed."""
    device = torch.device("cuda" if device is None else device)
    pv, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": _normal((pv, d), 0.02, generator, dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal((pv, d), 0.02, generator, dtype, device)

    def block(kind, lead=()):
        return {n: torch.empty(lead + s, dtype=dtype, device=device)
                for n, s in _block_shapes(cfg, kind).items()}

    period: Dict[str, Any] = {}
    for j, kind in enumerate(cfg.block_pattern):
        stacked = block(kind, (cfg.n_periods,))
        # One period at a time: the f32 draw is one period's size.
        for p in range(cfg.n_periods):
            _init_block({n: t[p] for n, t in stacked.items()}, cfg, kind,
                        generator, dtype, device)
        period[f"{j}_{kind}"] = stacked
    params["period"] = period
    rem: Dict[str, Any] = {}
    for j, kind in enumerate(cfg.remainder):
        rem[f"{j}_{kind}"] = blk = block(kind)
        _init_block(blk, cfg, kind, generator, dtype, device)
    if rem:
        params["rem"] = rem
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


def _apply_block(x, bp, cfg: ModelConfig, kind: str, positions,
                 plain: bool = False, save_outs: bool = False):
    """One block of any kind.  ``save_outs``: the attention kinds run
    each half under its own checkpoint, so the backward keeps each
    half's input (x, and x plus the attention output) and recomputes the
    rest: the residuals of ``save_only_these_names("blk_attn_out",
    "blk_mlp_out")``, held as the sums the next half reads.  The
    recurrent kinds name no output, so JAX's policy recomputes them
    whole, as ``"full"`` does: one checkpoint around the block."""
    if kind in ATTN_KINDS:
        window = cfg.attn_window if kind == "attn_local" else 0

        def attn(x):
            return attention_block(L.rms_norm(x, bp["norm1"]), bp, cfg,
                                   positions, window=window, plain=plain)

        def mlp(x):
            y = L.rms_norm(x, bp["norm2"])
            if kind == "attn_moe":
                return moe_block(y, bp, cfg)
            return L.gated_mlp(y, bp["w_gate"], bp["w_up"], bp["w_down"],
                               cfg.mlp_kind)

        if save_outs:
            x = x + _checkpointed(attn, x)
            return x + _checkpointed(mlp, x)
        x = x + attn(x)
        return x + mlp(x)

    def recurrent(x):
        if kind == "rglru":
            x = x + rglru_block(L.rms_norm(x, bp["norm1"]), bp, cfg)
            y = L.rms_norm(x, bp["norm2"])
            return x + L.gated_mlp(y, bp["w_gate"], bp["w_up"],
                                   bp["w_down"], cfg.mlp_kind)
        if kind == "mlstm":
            return x + mlstm_block(L.rms_norm(x, bp["norm1"]), bp, cfg)
        if kind == "slstm":
            return x + slstm_block(L.rms_norm(x, bp["norm1"]), bp, cfg)
        raise ValueError(kind)

    return _checkpointed(recurrent, x) if save_outs else recurrent(x)


def _save_dots(ctx, op, *args, **kw):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of the
    products without batch dims (``x @ w``, which autograd sees as
    ``mm``); recompute the rest, attention's and the MoE experts'
    batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def forward(params, cfg: ModelConfig, tokens=None, embeds=None,
            labels=None, remat: str = "none"):
    """The mean cross entropy if ``labels`` [B, T] are given, else the
    final hidden states [B, T, d] of the prefill forward.

    tokens: int [B, T] (token archs); embeds: [B, T, d] (stub frontends).
    Without labels every causal attention layer (``attn``,
    ``attn_moe``) runs through ``kernels.ops.flash_attention_op``
    (forward only); with labels through the JAX package's plain
    attention, which autograd differentiates (``attention_block``'s
    ``plain``).  ``attn_local`` layers always take the plain windowed
    attention.  The remainder blocks follow the periods, outside the
    remat, as in the JAX package.

    ``remat``, as the JAX package's ``jax.checkpoint`` of each period:
    ``"none"``; ``"full"`` (``torch.utils.checkpoint`` around each
    period: the backward keeps only each period's input); ``"dots"``
    (the same with a selective policy that keeps the ``x @ w`` outputs,
    see :func:`_save_dots`); ``"save_outs"`` (each block's attention and
    MLP outputs, see :func:`_apply_block`).  All four give the same
    numbers; they trade memory for recompute.
    """
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
    plain = labels is not None
    if embeds is None:
        x = L.embed(tokens, params["embed"], cfg.embed_scale)
    else:
        x = embeds.to(params["embed"].dtype)
    b, t = x.shape[:2]
    x = maybe_shard(x, "dp", None, None)
    positions = torch.arange(t, device=x.device)[None].expand(b, t)

    def period_body(xc, p):
        for j, kind in enumerate(cfg.block_pattern):
            stacked = params["period"][f"{j}_{kind}"]
            xc = _apply_block(xc, {n: w[p] for n, w in stacked.items()},
                              cfg, kind, positions, plain=plain,
                              save_outs=remat == "save_outs")
        return maybe_shard(xc, "dp", None, None)

    for p in range(cfg.n_periods):
        if remat == "full":
            x = _checkpointed(period_body, x, p)
        elif remat == "dots":
            x = _checkpointed(period_body, x, p, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
        else:
            x = period_body(x, p)
    for j, kind in enumerate(cfg.remainder):
        x = _apply_block(x, params["rem"][f"{j}_{kind}"], cfg, kind,
                         positions, plain=plain)
    x = L.rms_norm(x, params["final_norm"])
    if labels is None:
        return x
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.logits_and_xent(x, table, labels)
