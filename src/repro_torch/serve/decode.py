"""Decode path: one new token per sequence against per-layer KV caches,
as in ``repro/serve/decode.py``, for the ``"attn"`` block kind.

The cache is a dict: ``pos`` int64[B] (each lane's write offset: lanes
join and leave independently) and, per block of the pattern, bf16 K and
V tensors [n_periods, B, S, Hkv, hd].  **The port updates the cache in
place** where the JAX package returns a new one: the step writes each
lane's new K/V row into its slot with an indexed write and advances
``pos``; :func:`reset_lane` zeroes one lane in place.  Both still
return the cache, so callers read as in the JAX package.

``_attn_decode`` is the JAX package's plain attention of one token
against the lane's cache; it runs no Pallas kernel there and stays
plain here.  The JAX package's sequence-sharded flash-decode layout
(``cache_specs``) has no counterpart on one card.  The recurrent caches
(RG-LRU, mLSTM, sLSTM) and sliding-window rings belong to block kinds
not yet ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import repeat_kv
from repro_torch.models.model import ModelConfig, check_config

NEG_INF = -2.0e38


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed caches on ``device`` (default: the card)."""
    check_config(cfg)
    device = torch.device("cuda" if device is None else device)
    shape = (cfg.n_periods, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    tree: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}
    tree["period"] = {
        f"{j}_{kind}": {n: torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device) for n in ("k", "v")}
        for j, kind in enumerate(cfg.block_pattern)}
    return tree


def reset_lane(cfg: ModelConfig, cache, lane: int):
    """Zero one lane's state in place (continuous batching: a new
    request takes over the lane).  The caches carry [period, B, ...]."""
    cache["pos"][lane] = 0
    for caches in cache["period"].values():
        for t in caches.values():
            t[:, lane] = 0
    return cache


def _attn_decode(x, bp, cfg: ModelConfig, cache, pos):
    """x: [B, 1, d]; writes the new K/V row of each lane at its slot."""
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
    slot = torch.clamp(pos, max=s_c - 1)
    lanes = torch.arange(b, device=x.device)
    k_c[lanes, slot] = k_new[:, 0].to(k_c.dtype)
    v_c[lanes, slot] = v_new[:, 0].to(v_c.dtype)
    n_valid = torch.clamp(pos + 1, max=s_c)                # [B]
    valid = (torch.arange(s_c, device=x.device)[None, :]
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


def _decode_block(x, bp, cfg: ModelConfig, cache, pos):
    x = x + _attn_decode(L.rms_norm(x, bp["norm1"]), bp, cfg, cache, pos)
    y = L.rms_norm(x, bp["norm2"])
    return x + L.gated_mlp(y, bp["w_gate"], bp["w_up"], bp["w_down"],
                           cfg.mlp_kind)


def decode_logits(params, cfg: ModelConfig, cache, tokens=None, embeds=None):
    """One decode step for the whole batch: the f32 logits [B, 1, Vp]
    of the new token of every lane; the cache is updated in place."""
    check_config(cfg)
    if embeds is None:
        x = L.embed(tokens, params["embed"], cfg.embed_scale)
    else:
        x = embeds.to(params["embed"].dtype)
    pos = cache["pos"]
    for p in range(cfg.n_periods):
        for j, kind in enumerate(cfg.block_pattern):
            key = f"{j}_{kind}"
            bps = {n: w[p] for n, w in params["period"][key].items()}
            bcs = {n: c[p] for n, c in cache["period"][key].items()}
            x = _decode_block(x, bps, cfg, bcs, pos)
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
