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
kernel there and stay plain here.  :func:`cache_specs` gives the JAX
package's layout of the caches on a mesh (the batch over the data axes,
K/V on the heads or, where the model axis does not split them, on the
sequence: flash-decode), and :func:`abstract_cache` their stand-ins for
the dry run.  Under a mesh the in-place writes run on each device's
shard (:func:`_write_rows`).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import repeat_kv
from repro_torch.models.model import ATTN_KINDS, ModelConfig
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import rglru_block
from repro_torch.models.sharding import (P, current_mesh, local_offsets,
                                         maybe_shard, replicated)
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


def _build_cache(cfg: ModelConfig, batch: int, seq_len: int, leaf,
                 pos_dtype) -> Dict[str, Any]:
    """The caches' tree, each tensor ``leaf(name, shape, dtype)``."""
    def caches(kind, lead=()):
        return {n: leaf(n, lead + shp, dt) for n, (shp, dt) in
                _kind_cache_shape(cfg, kind, batch, seq_len).items()}

    tree: Dict[str, Any] = {"pos": leaf("pos", (batch,), pos_dtype)}
    tree["period"] = {f"{j}_{kind}": caches(kind, (cfg.n_periods,))
                      for j, kind in enumerate(cfg.block_pattern)}
    if cfg.remainder:
        tree["rem"] = {f"{j}_{kind}": caches(kind)
                       for j, kind in enumerate(cfg.remainder)}
    return tree


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Fresh caches on ``device`` (default: the card): zeros, and the
    sLSTM's m at -1e30."""
    device = torch.device("cuda" if device is None else device)
    return _build_cache(cfg, batch, seq_len, lambda n, shp, dt: torch.full(
        shp, M_FILL if n == "m" else 0, dtype=dt, device=device),
        torch.int64)


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   device="meta"):
    """The caches' tree with shapes and the JAX package's dtypes (``pos``
    int32) and no values: meta tensors, or fake ones under a
    ``FakeTensorMode`` (the dry run's stand-ins)."""
    return _build_cache(cfg, batch, seq_len, lambda n, shp, dt: torch.empty(
        shp, dtype=dt, device=device), torch.int32)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                model_shards: int = 16):
    """The spec tree matching :func:`abstract_cache`: B over dp; KV
    sharded on heads when divisible, else on the sequence (flash-decode);
    leaf by leaf the JAX package's."""
    out: Dict[str, Any] = {"pos": P()}
    out["period"] = {
        f"{j}_{kind}": {n: _leaf(cfg, n, model_shards, stacked=True)
                        for n in _kind_cache_shape(cfg, kind, batch, seq_len)}
        for j, kind in enumerate(cfg.block_pattern)}
    if cfg.remainder:
        out["rem"] = {
            f"{j}_{kind}": {n: _leaf(cfg, n, model_shards, stacked=False)
                            for n in _kind_cache_shape(cfg, kind, batch,
                                                       seq_len)}
            for j, kind in enumerate(cfg.remainder)}
    return out


def _leaf(cfg: ModelConfig, name: str, model_shards: int, stacked: bool):
    dp = ("pod", "data")
    lead = (None,) if stacked else ()
    if name in ("k", "v"):
        if cfg.n_kv_heads % model_shards == 0:
            return P(*lead, dp, None, "model", None)
        return P(*lead, dp, "model", None, None)
    if name == "S":
        return P(*lead, dp, None, None, None)
    if name == "conv":
        return P(*lead, dp, None,
                 "model" if cfg.d_model % model_shards == 0 else None)
    if name in ("h", "c", "n", "m"):
        return P(*lead, dp, None)
    return P()


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
    _write_rows(k_c, slot, k_new[:, 0].to(k_c.dtype))
    _write_rows(v_c, slot, v_new[:, 0].to(v_c.dtype))
    n_valid = torch.clamp(pos + 1, max=s_c)                # [B]
    valid = (torch.arange(s_c, device=x.device)[None, :]   # ring: oldest kept
             < n_valid[:, None])

    n_rep = cfg.n_heads // cfg.n_kv_heads
    if current_mesh() is None:
        o = _attend(q, k_c, v_c, valid, n_rep, x.dtype)
    else:
        o = _attend_sharded(q, k_c, v_c, valid, n_rep, x.dtype)
    o = o.reshape(b, 1, cfg.n_heads * hd)
    return o @ bp["wo"]


def _scores(q, k_c, n_rep: int):
    """f32 scaled scores [B, H, 1, S] of the query against the cache."""
    # bf16 cache against an f32 query promotes to f32, as jnp does.
    ct = torch.promote_types(q.dtype, k_c.dtype)
    k_full = repeat_kv(k_c, n_rep).flatten(2, 3).to(ct)
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bthd,bshd->bhts", q.to(ct), k_full).float() * scale


def _probs(scores, valid, dtype):
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _mix(probs, v_c, n_rep: int):
    """The probabilities' mix of the cache's values: [B, 1, H, hd]."""
    v_full = repeat_kv(v_c, n_rep).flatten(2, 3)
    pt = torch.promote_types(probs.dtype, v_full.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.to(pt), v_full.to(pt))


def _attend(q, k_c, v_c, valid, n_rep: int, dtype):
    """The plain attention of one token against the lanes' caches."""
    return _mix(_probs(_scores(q, k_c, n_rep), valid, dtype), v_c, n_rep)


def _attend_sharded(q, k_c, v_c, valid, n_rep: int, dtype):
    """:func:`_attend` under a mesh, as an explicit local region (DTensor's
    view rules refuse the einsums over a batch-sharded cache in some
    versions).  Each device takes its shard of the cache as it lies
    (lanes over the data axes; heads, or the sequence for flash-decode,
    over the model axis) and the query's matching rows and heads.  On a
    sequence-sharded cache the scores are gathered over the sequence for
    the softmax, each device mixes its own rows, and the partial sums
    are all-reduced.  On one device this is :func:`_attend`, op for op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k_c.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, rep, run_check=False)
    if not isinstance(valid, DTensor):
        valid = DTensor.from_local(valid, mesh, rep, run_check=False)
    cpl = k_c.placements
    seq = [m for m, p in enumerate(cpl) if p == Shard(1)]
    # The query as the cache lies: its lanes (dim 0) and heads (dim 2).
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cpl]
    ql = q.redistribute(mesh, q_pl).to_local()
    (bl, sl, _, _), (b0, s0, _, _) = local_offsets(k_c)
    vl = valid.redistribute(mesh, rep).to_local()[b0:b0 + bl]
    s = _scores(ql, k_c.to_local(), n_rep)
    if seq:
        s_pl = [Shard(3) if m in seq else p for m, p in enumerate(q_pl)]
        full_pl = [Replicate() if m in seq else p for m, p in enumerate(q_pl)]
        s = (DTensor.from_local(s, mesh, s_pl, run_check=False)
             .redistribute(mesh, full_pl).to_local())
        probs = _probs(s, vl, dtype)[..., s0:s0 + sl]
    else:
        probs = _probs(s, vl, dtype)
    o = _mix(probs, v_c.to_local(), n_rep)
    o_pl = [Partial() if m in seq else p for m, p in enumerate(q_pl)]
    o_shape = tuple(q.shape)
    o = DTensor.from_local(o, mesh, o_pl, run_check=False, shape=o_shape,
                           stride=tuple(math.prod(o_shape[i + 1:])
                                        for i in range(len(o_shape))))
    return o.redistribute(mesh, [Replicate() if m in seq else p
                                 for m, p in enumerate(o_pl)])


def _write_rows(c, slot, rows) -> None:
    """``c[b, slot[b]] = rows[b]`` for every lane b, in place (c: [B, S,
    Hkv, hd], rows [B, Hkv, hd]).  Under a mesh, on each device's shard
    of ``c``: its lanes, and on a sequence-sharded cache only the slots
    in its range (an entry outside it writes its shard's own row back)."""
    if current_mesh() is None:
        c[torch.arange(c.shape[0], device=c.device), slot] = rows
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = c.device_mesh
    shape, off = local_offsets(c)
    # rows as c's lanes and heads are placed: c's dim 2 is rows' dim 1.
    row_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
              else Replicate() for p in c.placements]
    rows = rows.redistribute(mesh, row_pl).to_local()
    rep = [Replicate()] * mesh.ndim
    s = slot.redistribute(mesh, rep).to_local()[off[0]:off[0] + shape[0]]
    cl = c.to_local()
    ok = (s >= off[1]) & (s < off[1] + shape[1])
    s = torch.where(ok, s - off[1], 0)
    lanes = torch.arange(shape[0], device=cl.device)
    cl[lanes, s] = torch.where(ok[:, None, None], rows, cl[lanes, s])


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
    x = maybe_shard(x, "dp", None, None)
    pos = cache["pos"]
    for p in range(cfg.n_periods):
        for j, kind in enumerate(cfg.block_pattern):
            key = f"{j}_{kind}"
            bps = {n: w[p] for n, w in params["period"][key].items()}
            bcs = {n: c[p] for n, c in cache["period"][key].items()}
            x = _decode_block(x, bps, cfg, kind, bcs, pos)
        x = maybe_shard(x, "dp", None, None)
    for j, kind in enumerate(cfg.remainder):
        key = f"{j}_{kind}"
        x = _decode_block(x, params["rem"][key], cfg, kind,
                          cache["rem"][key], pos)
    pos += 1
    x = L.rms_norm(x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return maybe_shard(torch.einsum("btd,vd->btv", x, table).float(),
                       "dp", None, "model")


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens|embeds) -> (next_token, cache).

    One decode step for the whole batch (greedy); the cache is updated
    in place and returned.  Under a mesh the argmax runs on the gathered
    last-token logits (``sharding.replicated``): DTensor's argmax over a
    sharded vocab fails at a batch of one."""

    def serve_step(params, cache, tokens=None, embeds=None):
        logits = decode_logits(params, cfg, cache, tokens, embeds)
        next_token = replicated(lambda x: torch.argmax(x, dim=-1),
                                logits[:, -1, :cfg.vocab_size])
        return next_token.to(torch.int32), cache

    return serve_step
