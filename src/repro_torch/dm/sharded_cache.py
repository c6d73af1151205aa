"""The disaggregated-memory (DM) runtime on one card: the Ditto cache
split into memory shards, each a contiguous bucket range of the table,
with a group of client lanes per shard.

A torch port of ``repro/dm/sharded_cache.py``.  The JAX package puts a
shard on each device of a mesh and exchanges requests with an
``all_to_all``; here the shards are a leading axis of one card's
tensors, in the JAX package's layout:

* the slot columns stay one global ``[n_slots]`` tensor, shard k owning
  slots ``k*ls ... (k+1)*ls`` (``ls = local_cfg.n_slots``), and
  ``bucket_ver`` the same way by buckets;
* the per-shard scalars (``SHARD_SCALARS``) have a leading ``[S]`` axis;
* client lanes are ``[S*lanes]``, shard k's lanes ``k*lanes ...``, and
  every ``OpStats`` counter is ``[S]``.

A DM step routes each round's requests to their owner shards (a stable
pack by owner, at most ``q`` a source and destination; the op sideband
word carries the write bit, size, shadow bit and tenant), exchanges them
(the ``all_to_all`` becomes a permute of a [S_src, G, S_dst, q] send
buffer into [S_dst, G, S_src, q]), runs ``core/cache.py::access_group_``
once per shard on views of that shard's slice (its columns written in
place, its scalars stacked back), syncs the expert weights across the
shards, and merges the hits back onto their source lanes.  Routing
reads only the keys and the membership, so :func:`dm_execute` routes
every group of a trace up front in one batched pass and replays the
per-group step, S shard steps, through ``core/cache.py::_scan``: one
CUDA graph replay a group on the card.  The membership reaches the step
only through the routed inputs, so a failover or a new replica map
changes values, never the captured graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.cache import (_read_word, _repeat, _san_kw, _scan,
                                    _san_carry, _seqsum, _xla_sum0,
                                    access_group_, apply_penalties)
from repro_torch.core.hashing import bucket_of, hash_key, splitmix32
from repro_torch.core.types import (CacheConfig, CacheState, ClientState,
                                    OpStats, init_cache, init_clients,
                                    on_device, split_tenant_budgets)

I64 = torch.int64

# Salt decorrelating the replica pick from the bucket hash.
_PICK_SALT = 0x9E3779B9

# The slot columns (global [n_slots] tensors, shard k's slice its own).
SLOT_COLUMNS = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts",
                "freq", "ext", "values", "tenant")
# The per-shard scalars ([S] leading axis), and those a step rebinds.
SHARD_SCALARS = ("n_cached", "bytes_cached", "hist_ctr", "clock", "weights",
                 "gds_L", "capacity_blocks", "tenant_bytes", "tenant_budget",
                 "l0_epoch")
STEP_SCALARS = ("n_cached", "bytes_cached", "hist_ctr", "clock", "weights",
                "gds_L", "tenant_bytes")


class DMCache(NamedTuple):
    state: CacheState      # global slot columns, [S] per-shard scalars
    clients: ClientState   # [S*lanes] client lanes
    stats: OpStats         # [S] per-shard counters


class Membership(NamedTuple):
    """Routing-time membership (DESIGN.md §14).  ``primary``/``replica``
    are the router's view; ``serving`` is ground truth: between a failure
    and its detection requests still route to the dead shard and bounce
    (``route_drops``)."""
    primary: torch.Tensor  # i64[global_buckets] owner shard per bucket
    replica: torch.Tensor  # i64[global_buckets] secondary (S = none)
    serving: torch.Tensor  # bool[S] ground-truth liveness


def identity_membership(n_shards: int, global_buckets: int,
                        device=None) -> Membership:
    """No replication, every shard alive: owner = bucket // local
    buckets."""
    device = on_device(device, "identity_membership")
    local_buckets = global_buckets // n_shards
    return Membership(
        primary=torch.arange(global_buckets, device=device) // local_buckets,
        replica=torch.full((global_buckets,), n_shards, dtype=I64,
                           device=device),
        serving=torch.ones((n_shards,), dtype=torch.bool, device=device))


def _deprecated(name: str) -> None:
    import warnings
    warnings.warn(
        f"{name} is deprecated; build and drive clusters through "
        "repro_torch.dm.Cluster and repro_torch.core.execute()",
        DeprecationWarning, stacklevel=3)


def dm_make(cfg: CacheConfig, n_shards: int, lanes_per_shard: int,
            seed: int = 0, device=None):
    """Deprecated: build clusters with ``Cluster.make``.  Returns the
    same (device, DMCache, local_cfg) triple as its fields."""
    _deprecated("dm_make")
    return _dm_make_impl(cfg, n_shards, lanes_per_shard, seed, device)


def _dm_make_impl(cfg: CacheConfig, n_shards: int, lanes_per_shard: int,
                  seed: int = 0, device=None):
    """A sharded cache: ``cfg`` describes the global pool; each shard
    runs a local cache over 1/n_shards of its buckets and capacity."""
    device = on_device(device, "Cluster.make")
    assert cfg.n_buckets % n_shards == 0
    assert cfg.capacity % n_shards == 0
    assert cfg.capacity_blocks % n_shards == 0
    local = dataclasses.replace(
        cfg, n_buckets=cfg.n_buckets // n_shards,
        capacity=cfg.capacity // n_shards,
        capacity_blocks=cfg.capacity_blocks // n_shards,
        hist_len=cfg.history_len // n_shards)
    state = init_cache(cfg, device)

    def rep(x):
        return x[None].expand((n_shards,) + tuple(x.shape)).clone()

    state = state._replace(
        **{f: rep(getattr(state, f)) for f in STEP_SCALARS + ("l0_epoch",)},
        capacity_blocks=torch.full((n_shards,), local.budget_blocks,
                                   dtype=I64, device=device),
        tenant_budget=torch.as_tensor(
            split_tenant_budgets(cfg.tenant_budgets, n_shards).astype(
                np.int64), device=device))
    clients = init_clients(cfg, n_shards * lanes_per_shard, seed, device)
    stats = OpStats(*[torch.zeros((n_shards,), dtype=I64, device=device)
                      for _ in OpStats._fields])
    return device, DMCache(state, clients, stats), local


def _shard_state(state: CacheState, k: int, ls: int, lb: int) -> CacheState:
    """Shard k's CacheState: views of its slice of the columns and of its
    scalars, so a step's in-place writes land in the global tensors."""
    view = {f: getattr(state, f)[k * ls:(k + 1) * ls] for f in SLOT_COLUMNS}
    view["bucket_ver"] = state.bucket_ver[k * lb:(k + 1) * lb]
    view.update({f: getattr(state, f)[k] for f in SHARD_SCALARS})
    return CacheState(**view)


def _shard_lanes(clients: ClientState, k: int, lanes: int) -> ClientState:
    return ClientState(*[x[k * lanes:(k + 1) * lanes] for x in clients])


def _pad_clients(clients: ClientState, n: int,
                 rng: torch.Tensor | None = None) -> ClientState:
    """A shard's lanes presented as n request lanes: the lanes repeated,
    and every lane past the originals folds its index into its rng, so
    no two presented lanes share a stream; the originals keep theirs.
    ``rng``: those n keys, already folded (:func:`_padded_rng`)."""
    lanes = clients.fc_slot.shape[0]
    reps = -(-n // lanes)
    padded = ClientState(*[torch.cat([x] * reps)[:n] for x in clients])
    if rng is not None:
        return padded._replace(rng=rng)
    if n <= lanes:
        return padded
    idx = torch.arange(lanes, n, device=padded.rng.device)
    return padded._replace(rng=torch.cat(
        [padded.rng[:lanes], prng.fold_in(padded.rng[lanes:], idx)]))


class PaddedRng(NamedTuple):
    """A DM step's constant carry part: every shard's presented lanes'
    keys [S, n, 2].  The step never changes a lane's key, so they are
    folded once a ``dm_execute`` call, not once a shard step."""
    rng: torch.Tensor


def _padded_rng(clients: ClientState, n_shards: int, lanes: int,
                n: int) -> PaddedRng:
    return PaddedRng(torch.stack([
        _pad_clients(_shard_lanes(clients, k, lanes), n).rng
        for k in range(n_shards)]))


def _unpad_clients(orig: ClientState, padded: ClientState,
                   lanes: int) -> ClientState:
    """The first ``lanes`` presented lanes carry on; with fewer presented
    lanes than lanes, the originals stay as they were."""
    return ClientState(*[p[:lanes] if p.shape[0] >= lanes else o
                         for o, p in zip(orig, padded)])


def _route_capacity(lanes: int, n_shards: int, route_factor: int) -> int:
    if route_factor <= 0:
        return lanes
    return max(1, min(lanes, route_factor * lanes // n_shards + 1))


class Routed(NamedTuple):
    keys: torch.Tensor      # i64[..., S_src, S_dst, q] (0 = empty)
    meta: torch.Tensor      # i64[..., S_src, S_dst, q] sideband word
    src_slot: torch.Tensor  # i64[..., S_src, S_dst, q] source lane (-1)
    n_drop: torch.Tensor    # i64[..., S_src] requests over capacity
    n_rep_drop: torch.Tensor  # i64[..., S_src] mirrors over capacity


def _route(n_shards: int, lanes: int, q: int, global_buckets: int, keys,
           write, size, ten, member: Membership) -> Routed:
    """The client-side router, for every round and source shard at once:
    keys etc. [..., S_src, lanes].  Each round's requests go to their
    owners (a replicated bucket's reads split across both copies by a
    hash of the key; its writes go to the primary and mirror to the
    secondary as shadow ops, lane indices [lanes, 2*lanes)), packed per
    destination by a stable sort on ``owner * (2L + 1) + index``; at most
    ``q`` a destination, the rest counted as drops."""
    S, L2 = n_shards, 2 * lanes
    kh = hash_key(keys)
    bkt = bucket_of(kh, global_buckets)
    primary = member.primary[bkt]
    sec = member.replica[bkt]
    live = keys != 0
    has_sec = (sec < S) & (sec != primary)
    pick = (splitmix32(kh ^ _PICK_SALT) & 1).bool()
    owner = torch.where(has_sec & ~write & pick, sec, primary)
    owner = torch.where(live, owner, S)
    mirror = live & write & has_sec
    keys_c = torch.cat([keys, torch.where(mirror, keys, 0)], dim=-1)
    owner_c = torch.cat([owner, torch.where(mirror, sec, S)], dim=-1)
    shadow = torch.zeros_like(keys_c, dtype=torch.bool)
    shadow[..., lanes:] = True
    # The op sideband word: tenant << 10 | shadow << 9 | size << 1 | write.
    meta_c = ((torch.cat([ten, ten], dim=-1) << 10) | (shadow.to(I64) << 9)
              | (torch.cat([size, size], dim=-1) << 1)
              | torch.cat([write, write], dim=-1).to(I64))
    ar = torch.arange(L2, device=keys.device)
    order = torch.argsort(owner_c * (L2 + 1) + ar, dim=-1, stable=True)
    so = torch.gather(owner_c, -1, order)
    first = torch.ones_like(so, dtype=torch.bool)
    first[..., 1:] = so[..., 1:] != so[..., :-1]
    seg_start = torch.cummax(torch.where(first, ar, 0), dim=-1).values
    rank = ar - seg_start
    ok = rank < q
    # Scatter into [..., S + 1, q]: row S collects what is dropped.
    at = torch.where(ok, so, S) * q + torch.where(ok, rank, 0)
    lead = keys.shape[:-1]

    def scatter(src, fill):
        buf = torch.full(lead + ((S + 1) * q,), fill, dtype=I64,
                         device=keys.device)
        buf.scatter_(-1, at, src)
        return buf.reshape(lead + (S + 1, q))[..., :S, :]

    k_sorted = torch.gather(keys_c, -1, order)
    over = ~ok & (k_sorted != 0)
    return Routed(
        keys=scatter(k_sorted, 0),
        meta=scatter(torch.gather(meta_c, -1, order), 2),
        src_slot=scatter(order, -1),
        n_drop=(over & (order < lanes)).sum(dim=-1),
        n_rep_drop=(over & (order >= lanes)).sum(dim=-1))


class Received(NamedTuple):
    """One group's requests as each destination shard receives them:
    [S_dst, G, S_src * q] (a step's xs)."""
    keys: torch.Tensor
    is_write: torch.Tensor
    size: torch.Tensor
    tenant: torch.Tensor
    shadow: torch.Tensor


def _exchange(rt: Routed, serving: torch.Tensor):
    """The ``all_to_all`` as a permute: [NG, G, S_src, S_dst, q] send
    buffers become [NG, S_dst, G, S_src*q] receive buffers; then the
    ground-truth liveness gate: a request that reaches a non-serving
    shard is lost, counted as a route drop (a mirror: a replica drop).
    Returns (Received, bounced real [NG, S_dst], bounced mirrors)."""
    NG, G, S, _, q = rt.keys.shape

    def permute(x):
        return x.permute(0, 3, 1, 2, 4).reshape(NG, S, G, S * q)

    keys, meta = permute(rt.keys), permute(rt.meta)
    sh = ((meta >> 9) & 1).bool()
    up = serving[None, :, None, None]
    bounced = (keys != 0) & ~up
    n_real = (bounced & ~sh).sum(dim=(2, 3))
    n_shadow = (bounced & sh).sum(dim=(2, 3))
    recv = Received(keys=torch.where(up, keys, 0),
                    is_write=(meta & 1).bool(), size=(meta >> 1) & 0xFF,
                    tenant=meta >> 10, shadow=sh)
    return recv, n_real, n_shadow


def _back_merge(hit_back: torch.Tensor, src_slot: torch.Tensor,
                lanes: int) -> torch.Tensor:
    """Each destination's [NG, S_dst, G, S_src*q] hits back onto their
    source lanes: [NG, G, S_src*lanes].  Mirror entries (src_slot >=
    lanes) are replication traffic and never reach a client."""
    NG, S, G, _ = hit_back.shape
    q = src_slot.shape[-1]
    hb = hit_back.reshape(NG, S, G, S, q).permute(0, 2, 3, 1, 4)
    valid = (src_slot >= 0) & (src_slot < lanes)
    at = torch.where(valid, src_slot, lanes).reshape(NG, G, S, S * q)
    out = torch.zeros((NG, G, S, lanes + 1), dtype=torch.bool,
                      device=hit_back.device)
    out.scatter_(-1, at, (hb & valid).reshape(NG, G, S, S * q))
    return out[..., :lanes].reshape(NG, G, S * lanes)


def _sync_weights(local_cfg: CacheConfig, state: CacheState,
                  clients: ClientState, n_shards: int):
    """The lazy weight update across shards (§4.3.2): when any shard's
    lanes hold ``sync_period`` regrets, every shard applies the sum of
    all shards' pending penalties (the ``pmax`` and ``psum`` of the JAX
    package, summed in shard order as its CPU all-reduce does)."""
    S = n_shards
    cnt = clients.penalty_cnt.reshape(S, -1)
    do_sync = (cnt.sum(dim=1) >= local_cfg.sync_period).any()
    acc = clients.penalty_acc.reshape((S, -1) + clients.penalty_acc.shape[1:])
    pen = _xla_sum0(acc.transpose(0, 1))                     # [S, (T,) E]
    pen_global = _seqsum(torch.where(do_sync, pen, 0.0))
    w = apply_penalties(state.weights, pen_global, local_cfg.learning_rate)
    w = torch.where(do_sync, w, state.weights)
    lanes = acc.shape[1]
    state = state._replace(weights=w)
    clients = clients._replace(
        penalty_acc=torch.where(do_sync, 0.0, clients.penalty_acc),
        penalty_cnt=torch.where(do_sync, 0, clients.penalty_cnt),
        local_weights=torch.where(do_sync, _repeat(w, lanes),
                                  clients.local_weights))
    return state, clients


def _dm_step(local_cfg: CacheConfig, n_shards: int, lanes: int, q: int):
    """The per-group DM step for ``_scan``: each shard's access step on
    its views, then the cross-shard weight sync.  Carry (state, clients,
    stats, PaddedRng[, sanitizer word]); xs one group's
    :class:`Received`; y the hits [S_dst, G, S_src*q]."""
    S = n_shards
    ls, lb = local_cfg.n_slots, local_cfg.n_buckets

    def step(carry, xs):
        state, clients, stats, pad, *san = carry
        recv = Received(*xs)
        outs = []
        for k in range(S):
            lanes_k = _shard_lanes(clients, k, lanes)
            st, cl, sa, res = access_group_(
                local_cfg, _shard_state(state, k, ls, lb),
                _pad_clients(lanes_k, S * q, pad.rng[k]),
                OpStats(*[f[k] for f in stats]),
                recv.keys[k], is_write=recv.is_write[k],
                obj_size=recv.size[k], tenant=recv.tenant[k],
                shadow=recv.shadow[k], **_san_kw(san))
            outs.append((st, _unpad_clients(lanes_k, cl, lanes), sa,
                         res.hit))
        sts, cls, sas, hits = zip(*outs)
        state = state._replace(**{f: torch.stack([getattr(s, f) for s in sts])
                                  for f in STEP_SCALARS})
        clients = ClientState(*[torch.cat(p) for p in zip(*cls)])
        stats = OpStats(*[torch.stack(p) for p in zip(*sas)])
        state, clients = _sync_weights(local_cfg, state, clients, S)
        return (state, clients, stats, pad, *san), (torch.stack(hits),)

    return step


def dm_access(local_cfg: CacheConfig, dm: DMCache, keys, is_write=None,
              obj_size=None, tenant=None, route_factor: int = 4,
              member: Membership | None = None):
    """Deprecated single-step DM driver: drive traces through
    ``repro_torch.core.execute`` or :func:`dm_execute`."""
    _deprecated("dm_access")
    return _dm_access_impl(local_cfg, dm, keys, is_write, obj_size, tenant,
                           route_factor, member)


def _dm_access_impl(local_cfg: CacheConfig, dm: DMCache, keys,
                    is_write=None, obj_size=None, tenant=None,
                    route_factor: int = 4, member: Membership | None = None
                    ) -> Tuple[DMCache, torch.Tensor]:
    """One DM step: keys [S*lanes] or a request group [G, S*lanes] (0 =
    no-op); returns hits of the same shape.  ``dm`` is not written."""
    opt = (is_write, obj_size, tenant)
    if keys.dim() == 1:
        dm, hits = dm_execute(local_cfg, dm, keys[None], *opt,
                              route_factor=route_factor, member=member)
        return dm, hits[0]
    dm, hits = dm_execute(local_cfg, dm, keys[None],
                          *(None if x is None else x[None] for x in opt),
                          route_factor=route_factor, member=member)
    return dm, hits[0]


def dm_execute(local_cfg: CacheConfig, dm: DMCache, keys, is_write=None,
               obj_size=None, tenant=None, route_factor: int = 4,
               member: Membership | None = None
               ) -> Tuple[DMCache, torch.Tensor]:
    """Run a sequence of request groups: keys [T, S*lanes] (single rounds)
    or [NG, G, S*lanes]; hits come back in the same shape.  Equal to one
    :func:`dm_access` a leading index: every group is routed up front
    (routing reads only the keys and the membership), then the groups'
    steps run through ``_scan`` (one CUDA graph replay each on the card).
    ``route_factor`` sets the per-destination capacity ``q = min(lanes,
    route_factor * lanes / S + 1)`` (``<= 0``: q = lanes, nothing
    dropped); requests over it count in ``OpStats.route_drops``.
    ``member`` (default: identity) carries replication and failover.
    ``dm`` is not written."""
    S = dm.state.n_cached.shape[0]
    dev = dm.state.key.device
    flat = keys.dim() == 2
    if flat:
        keys, is_write, obj_size, tenant = (
            None if x is None else x[:, None]
            for x in (keys, is_write, obj_size, tenant))
    NG, G, width = keys.shape
    lanes = width // S
    q = _route_capacity(lanes, S, route_factor)
    if NG == 0:
        return dm, torch.zeros((0,) + ((width,) if flat else (G, width)),
                               dtype=torch.bool, device=dev)
    keys = keys.to(I64)
    z = torch.zeros_like(keys)
    is_write = z.bool() if is_write is None else is_write.bool()
    obj_size = z + 1 if obj_size is None else obj_size.to(I64)
    tenant = z if tenant is None else tenant.to(I64)
    if member is None:
        member = identity_membership(S, local_cfg.n_buckets * S, dev)

    def split(x):
        return x.reshape(NG, G, S, lanes)

    rt = _route(S, lanes, q, local_cfg.n_buckets * S, split(keys),
                split(is_write), split(torch.clamp(obj_size, 1, 254)),
                split(tenant), member)
    recv, n_bnc, n_bnc_sh = _exchange(rt, member.serving)
    stats = dm.stats._replace(
        route_drops=dm.stats.route_drops + rt.n_drop.sum(dim=(0, 1))
        + n_bnc.sum(dim=0),
        replica_drops=dm.stats.replica_drops
        + rt.n_rep_drop.sum(dim=(0, 1)) + n_bnc_sh.sum(dim=0))

    pad = _padded_rng(dm.clients, S, lanes, S * q)
    (state, clients, stats, _, *san), (hit_back,) = _scan(
        _dm_step(local_cfg, S, lanes, q),
        (dm.state, dm.clients, stats, pad) + _san_carry(local_cfg, dev),
        tuple(recv), ("dm_step", local_cfg, S, lanes, q))
    _read_word(san)
    hits = _back_merge(hit_back, rt.src_slot, lanes)
    if flat:
        hits = hits[:, 0]
    return DMCache(state, clients, stats), hits


def dm_set_capacity(dm: DMCache, new_global_capacity: int,
                    n_shards: int) -> DMCache:
    """Deprecated: use ``Cluster.with_capacity(blocks)``."""
    _deprecated("dm_set_capacity")
    from repro_torch.elastic.resize import _set_capacity_impl
    return _set_capacity_impl(dm, new_global_capacity, n_shards)
