"""The plain reference of the DM pool, frozen with the benchmark: the
table split into S memory shards, each owning a contiguous range of the
buckets and a 1/S share of the capacity, with ``lanes`` client lanes a
shard.

For each round of each group, every source shard's lanes send their
requests to the shard that owns the key's bucket, at most ``q`` a
(source, destination) pair in lane order; the rest are route drops.  A
destination takes what it received as [G, S*q] requests, source shard by
source shard, and runs one cache step on them with its lanes presented
``S*q`` wide (its lanes repeated; each copy past the first folds its
index into its key).  After all shards have stepped, when any shard's
lanes hold ``sync_period`` regrets, every shard applies the sum over all
shards (in shard order) of their lanes' pending penalties.  Each request's
hit goes back to its source lane.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import cache as ref
from bench.reference.plan import buckets_of


def route_capacity(lanes, n_shards, route_factor):
    if route_factor <= 0:
        return lanes
    return max(1, min(lanes, route_factor * lanes // n_shards + 1))


def route(keys, is_write, n_shards, lanes, q, n_buckets):
    """keys u32 [NG, G, S*lanes] (numpy).  Returns what each destination
    receives, keys and is_write [NG, S, G, S*q], the source lane of each
    received request (-1: none), and the drops of each source shard [S]."""
    NG, G, _ = keys.shape
    S = n_shards
    owner = buckets_of(keys, n_buckets) // (n_buckets // S)
    rk = np.zeros((NG, S, G, S * q), np.int64)
    rw = np.zeros((NG, S, G, S * q), bool)
    src = np.full((NG, S, G, S * q), -1, np.int64)
    drops = np.zeros(S, np.int64)
    for n in range(NG):
        for g in range(G):
            for s in range(S):
                used = [0] * S
                for lane in range(lanes):
                    i = s * lanes + lane
                    k = int(keys[n, g, i])
                    if k == 0:
                        continue
                    d = int(owner[n, g, i])
                    if used[d] >= q:
                        drops[s] += 1
                        continue
                    at = s * q + used[d]
                    used[d] += 1
                    rk[n, d, g, at] = k
                    rw[n, d, g, at] = bool(is_write[n, g, i])
                    src[n, d, g, at] = i
    return rk, rw, src, drops


def presented_rng(rng, lanes, n):
    """A shard's ``lanes`` keys presented as n lanes: repeated, and every
    copy past the originals folds its index into its key."""
    reps = -(-n // lanes)
    rep = torch.cat([rng] * reps)[:n]
    if n <= lanes:
        return rep
    idx = torch.arange(lanes, n, device=rng.device)
    return torch.cat([rep[:lanes], ref.fold_in(rep[lanes:], idx)])


def run_call(cfg, n_shards, lanes, st, cl, stats, keys, is_write,
             route_factor):
    """One call of [NG, G, S*lanes] requests on the whole pool: ``st``
    (global slot columns, [S] scalars): its columns are written in place.
    Returns (state, clients, stats [S] each, hits bool [NG, G, S*lanes]
    numpy)."""
    S = n_shards
    local = cfg.shard(S)
    ls = local.n_slots
    dev = st["key"].device
    q = route_capacity(lanes, S, route_factor)
    NG, G, _ = keys.shape
    rk, rw, src, drops = route(keys, is_write, S, lanes, q, cfg.n_buckets)
    stats = dict(stats, route_drops=stats["route_drops"]
                 + torch.as_tensor(drops, device=dev))
    pad = [presented_rng(cl["rng"][k * lanes:(k + 1) * lanes], lanes, S * q)
           for k in range(S)]
    rk_t = torch.as_tensor(rk, device=dev)
    rw_t = torch.as_tensor(rw, device=dev)
    hit_back = np.zeros(rk.shape, bool)
    for n in range(NG):
        scal, lanes_out, stats_out = [], [], []
        for k in range(S):
            view = {f: st[f][k * ls:(k + 1) * ls] for f in ref.SLOT_COLUMNS}
            view.update({f: st[f][k] for f in ref.SCALARS})
            mine = {f: x[k * lanes:(k + 1) * lanes] for f, x in cl.items()}
            presented = {f: torch.cat([x] * -(-S * q // lanes))[:S * q]
                         for f, x in mine.items()}
            presented["rng"] = pad[k]
            sc, out, sa, hit = ref.step(
                local, view, presented, {f: v[k] for f, v in stats.items()},
                rk_t[n, k], rw_t[n, k],
                shadow=torch.zeros_like(rw_t[n, k]))
            scal.append(sc)
            lanes_out.append({f: x[:lanes] for f, x in out.items()})
            stats_out.append(sa)
            hit_back[n, k] = hit.cpu().numpy()
        for f in scal[0]:
            st[f] = torch.stack([s[f] for s in scal])
        cl = {f: torch.cat([c[f] for c in lanes_out]) for f in cl}
        stats = {f: torch.stack([s[f] for s in stats_out]) for f in stats}
        st, cl = sync_weights(local, st, cl, S, lanes)
    hits = np.zeros(keys.shape, bool)
    ok = src >= 0
    n_i, d_i, g_i, _ = np.nonzero(ok)
    hits[n_i, g_i, src[ok]] = hit_back[ok]
    return st, cl, stats, hits


def sync_weights(local, st, cl, S, lanes):
    """The lazy weight update across shards."""
    cnt = cl["penalty_cnt"].reshape(S, lanes)
    do_sync = (cnt.sum(dim=1) >= local.sync_period).any()
    acc = cl["penalty_acc"].reshape(S, lanes, -1)
    pen = ref.ranged_sum0(acc.transpose(0, 1))
    pen_global = ref.seqsum(torch.where(do_sync, pen, 0.0))
    w = ref.apply_penalties(st["weights"], pen_global, local.learning_rate)
    w = torch.where(do_sync, w, st["weights"])
    st = dict(st, weights=w)
    cl = dict(cl, penalty_acc=torch.where(do_sync, 0.0, cl["penalty_acc"]),
              penalty_cnt=torch.where(do_sync, 0, cl["penalty_cnt"]),
              local_weights=torch.where(do_sync, ref.repeat_rows(w, lanes),
                                        cl["local_weights"]))
    return st, cl
