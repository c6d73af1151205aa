"""Decode path: one new token per sequence against per-layer caches, as
in ``repro/serve/decode.py``.

Cache kinds (per block), with the JAX package's dtypes:
  * attention (``attn``, ``attn_moe``): bf16 K and V [B, S, Hkv, hd];
    ``attn_local`` a ring of ``min(seq_len, window)`` rows, written at
    ``pos % rows`` with RoPE applied at write time;
  * RG-LRU: the conv tail, bf16 [B, 3, D], and the f32 state [B, D];
  * mLSTM: the f32 matrix memory S [B, H, D, D] and normaliser n;
  * sLSTM: h (bf16), c, n and m (f32; m starts at -1e30).

The cache is a dict: ``pos`` int64[B] (each lane's write offset: lanes
join and leave independently), per block of the pattern its tensors
with a leading period axis [n_periods, B, ...] under ``period``, and
per remainder block its tensors [B, ...] under ``rem``.  **The port
updates the cache in place** where the JAX package returns a new one:
the step writes each lane's new K/V row into its slot with an indexed
write, copies each recurrent state over the old one and advances
``pos``; :func:`reset_lane` refills one lane in place.  Both still
return the cache, so callers read as in the JAX package.

``_attn_decode`` is the JAX package's plain attention of one token
against the lane's cache; it and the recurrent steps run no Pallas
kernel there and stay plain here.  The JAX package's sequence-sharded
flash-decode layout (``cache_specs``) has no counterpart on one card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import repeat_kv
from repro_torch.models.model import ATTN_KINDS, ModelConfig
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import rglru_block
from repro_torch.models.xlstm import mlstm_block, slstm_block

NEG_INF = -2.0e38
M_FILL = -1e30          # the sLSTM stabiliser's start (a running max)


def _kind_cache_shape(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int) -> Dict[str, tuple]:
    bf16, f32 = torch.bfloat16, torch.float32
    if kind in ATTN_KINDS:
        s = min(seq_len, cfg.attn_window) if kind == "attn_local" else seq_len
        kv = (batch, s, cfg.n_kv_heads, cfg.hd)
        return {"k": (kv, bf16), "v": (kv, bf16)}
    if kind == "rglru":
        d = cfg.d_model
        return {"conv": ((batch, 3, d), bf16), "h": ((batch, d), f32)}
    if kind == "mlstm":
        h = cfg.n_heads
        dh = cfg.mlstm_d_in // h
        return {"S": ((batch, h, dh, dh), f32), "n": ((batch, h, dh), f32)}
    if kind == "slstm":
        d = cfg.d_model
        return {"h": ((batch, d), bf16), "c": ((batch, d), f32),
                "n": ((batch, d), f32), "m": ((batch, d), f32)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Fresh caches on ``device`` (default: the card): zeros, and the
    sLSTM's m at -1e30."""
    device = torch.device("cuda" if device is None else device)

    def caches(kind, lead=()):
        return {n: torch.full(lead + shp, M_FILL if n == "m" else 0,
                              dtype=dt, device=device)
                for n, (shp, dt) in _kind_cache_shape(
                    cfg, kind, batch, seq_len).items()}

    tree: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}
    tree["period"] = {f"{j}_{kind}": caches(kind, (cfg.n_periods,))
                      for j, kind in enumerate(cfg.block_pattern)}
    if cfg.remainder:
        tree["rem"] = {f"{j}_{kind}": caches(kind)
                       for j, kind in enumerate(cfg.remainder)}
    return tree


def reset_lane(cfg: ModelConfig, cache, lane: int):
    """Refill one lane's state in place (continuous batching: a new
    request takes over the lane): zeros, and -1e30 in the sLSTM's m.
    Period caches carry [period, B, ...], remainder caches [B, ...]."""
    cache["pos"][lane] = 0
    for part, idx in (("period", (slice(None), lane)), ("rem", (lane,))):
        for caches in cache.get(part, {}).values():
            for n, t in caches.items():
                t[idx] = M_FILL if n == "m" else 0
    return cache


def _attn_decode(x, bp, cfg: ModelConfig, cache, pos, *, window: int):
    """x: [B, 1, d]; writes the new K/V row of each lane at its slot (a
    ring of the window's rows where ``window > 0``)."""
    b = x.shape[0]
    hd = cfg.hd
    q = (x @ bp["wq"]).reshape(b, 1, cfg.n_heads, hd)
    k_new = (x @ bp["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    v_new = (x @ bp["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    posb = pos[:, None]                                    # [B, 1], per lane
    q = L.rope(q, posb, cfg.rope_theta)
    k_new = L.rope(k_new, posb, cfg.rope_theta)

    k_c, v_c = cache["k"], cache["v"]
    s_c = k_c.shape[1]
    slot = pos % s_c if window > 0 else torch.clamp(pos, max=s_c - 1)
    lanes = torch.arange(b, device=x.device)
    k_c[lanes, slot] = k_new[:, 0].to(k_c.dtype)
    v_c[lanes, slot] = v_new[:, 0].to(v_c.dtype)
    n_valid = torch.clamp(pos + 1, max=s_c)                # [B]
    valid = (torch.arange(s_c, device=x.device)[None, :]   # ring: oldest kept
             < n_valid[:, None])

    n_rep = cfg.n_heads // cfg.n_kv_heads
    # bf16 cache against an f32 query promotes to f32, as jnp does.
    ct = torch.promote_types(q.dtype, k_c.dtype)
    k_full = repeat_kv(k_c, n_rep).flatten(2, 3).to(ct)
    v_full = repeat_kv(v_c, n_rep).flatten(2, 3)
    scale = hd ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.to(ct), k_full).float() * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    pt = torch.promote_types(probs.dtype, v_full.dtype)
    o = torch.einsum("bhts,bshd->bthd", probs.to(pt), v_full.to(pt))
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return o @ bp["wo"]


def _decode_block(x, bp, cfg: ModelConfig, kind: str, cache, pos):
    """One block's decode step; its cache is updated in place."""
    if kind in ATTN_KINDS:
        window = cfg.attn_window if kind == "attn_local" else 0
        x = x + _attn_decode(L.rms_norm(x, bp["norm1"]), bp, cfg, cache,
                             pos, window=window)
        y = L.rms_norm(x, bp["norm2"])
        if kind == "attn_moe":
            return x + moe_block(y, bp, cfg)
        return x + L.gated_mlp(y, bp["w_gate"], bp["w_up"], bp["w_down"],
                               cfg.mlp_kind)
    if kind == "rglru":
        y, (conv_st, h_st) = rglru_block(
            L.rms_norm(x, bp["norm1"]), bp, cfg, conv_state=cache["conv"],
            h0=cache["h"], return_state=True)
        cache["conv"].copy_(conv_st)            # cast back to bf16
        cache["h"].copy_(h_st)
        x = x + y
        z = L.rms_norm(x, bp["norm2"])
        return x + L.gated_mlp(z, bp["w_gate"], bp["w_up"], bp["w_down"],
                               cfg.mlp_kind)
    if kind == "mlstm":
        y, (S, n) = mlstm_block(L.rms_norm(x, bp["norm1"]), bp, cfg,
                                state=(cache["S"], cache["n"]),
                                return_state=True)
        cache["S"].copy_(S)
        cache["n"].copy_(n)
        return x + y
    if kind == "slstm":
        st = tuple(cache[n] for n in ("h", "c", "n", "m"))
        y, new = slstm_block(L.rms_norm(x, bp["norm1"]), bp, cfg, state=st,
                             return_state=True)
        for old, t in zip(st, new):
            old.copy_(t)
        return x + y
    raise ValueError(kind)


def _check_slstm_carry(cfg: ModelConfig, cache, dtype) -> None:
    """The JAX package's decode refuses an sLSTM whose carried h (the
    cache's bf16) differs from the activations' dtype (f32 params):
    ``lax.scan`` rejects a carry that changes type.  Raise the same
    ``TypeError`` before any cache is written."""
    for part in ("period", "rem"):
        for key, c in cache.get(part, {}).items():
            if key.endswith("_slstm") and c["h"].dtype != dtype:
                raise TypeError(
                    f"{cfg.name}: the sLSTM cache's h is {c['h'].dtype} and "
                    f"the activations are {dtype}: scan body function carry "
                    "input and carry output must have equal types (the JAX "
                    "package decodes xLSTM with bf16 params only)")


def decode_logits(params, cfg: ModelConfig, cache, tokens=None, embeds=None):
    """One decode step for the whole batch: the f32 logits [B, 1, Vp]
    of the new token of every lane; the cache is updated in place."""
    if embeds is None:
        x = L.embed(tokens, params["embed"], cfg.embed_scale)
    else:
        x = embeds.to(params["embed"].dtype)
    _check_slstm_carry(cfg, cache, x.dtype)
    pos = cache["pos"]
    for p in range(cfg.n_periods):
        for j, kind in enumerate(cfg.block_pattern):
            key = f"{j}_{kind}"
            bps = {n: w[p] for n, w in params["period"][key].items()}
            bcs = {n: c[p] for n, c in cache["period"][key].items()}
            x = _decode_block(x, bps, cfg, kind, bcs, pos)
    for j, kind in enumerate(cfg.remainder):
        key = f"{j}_{kind}"
        x = _decode_block(x, params["rem"][key], cfg, kind,
                          cache["rem"][key], pos)
    pos += 1
    x = L.rms_norm(x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("btd,vd->btv", x, table).float()


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens|embeds) -> (next_token, cache).

    One decode step for the whole batch (greedy); the cache is updated
    in place and returned."""

    def serve_step(params, cache, tokens=None, embeds=None):
        logits = decode_logits(params, cfg, cache, tokens, embeds)
        next_token = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        return next_token.to(torch.int32), cache

    return serve_step
