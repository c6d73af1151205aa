"""``Cluster``: the one membership handle of the DM runtime (DESIGN.md
§14), a torch port of ``repro/dm/cluster.py``.

The handle holds the topology, the replica map and two views of shard
liveness: ``alive`` is ground truth (``inject_failure`` wipes the shard
and stops it serving; requests that still route there bounce into
``route_drops``), ``routed`` the router's belief (only ``mark_failed``
flips it, and ``membership()`` then re-routes the shard's buckets: a
replicated bucket promotes its live secondary, the rest rendezvous-hash
across the survivors).  ``membership()`` is a pure function of (alive,
routed, replicas), computed in numpy on the host, so reruns of a seeded
failure timeline route identically.

The JAX handle carries a device mesh; this one carries the card (or the
CPU) its tensors live on and its :class:`repro_torch.dm.ranks.Pool`: the
local pool (every shard in this process), or, for a pool spread over
the ranks of a ``torch.distributed`` group (``Cluster.make(...,
group=)``), this rank's share: ``dm`` is then this rank's block of
shards, while the membership, ``stats`` and every method's results are
global and equal on every rank, which all call the same methods with the
same arguments.  Its resizes (``with_capacity``, ``drain_to``,
``with_lanes``) run the elastic runtime's ``resize`` functions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.types import CacheConfig, OpStats, on_device
from repro_torch.dm import ranks
from repro_torch.dm.sharded_cache import (DMCache, Membership, _dm_make_impl,
                                          dm_execute)
from repro_torch.workloads.gen import _mix32

__all__ = ["Cluster", "with_capacity", "with_tenant_budgets", "with_lanes",
           "mark_failed", "replica_map"]


def _rendezvous_scores(n_buckets: int, n_shards: int) -> np.ndarray:
    """i64[n_buckets, n_shards] rendezvous weights: the highest score
    among the eligible shards owns the bucket; a pure hash of (bucket,
    shard), so membership changes move only a dead shard's buckets.  A
    copy the caller may write."""
    return _scores(n_buckets, n_shards).copy()


@functools.lru_cache(maxsize=4)
def _scores(n_buckets: int, n_shards: int) -> np.ndarray:
    M = np.uint64(0xFFFFFFFF)
    b = np.arange(n_buckets, dtype=np.uint64)[:, None]
    s = np.arange(n_shards, dtype=np.uint64)[None, :]
    x = ((b * np.uint64(2654435761)) & M) ^ (
        ((s + np.uint64(1)) * np.uint64(0x85EBCA6B)) & M)
    return _mix32(x).astype(np.int64)


def _as_tensor(x, device, dtype=torch.int64):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    return torch.as_tensor(a.astype(np.bool_ if dtype == torch.bool
                                    else np.int64), device=device)


class Cluster(NamedTuple):
    """Immutable cluster handle; every mutator returns a new Cluster."""

    device: torch.device
    cfg: CacheConfig               # global pool config
    local: CacheConfig             # per-shard slice of it
    dm: DMCache
    n_shards: int
    lanes_per_shard: int
    alive: Tuple[bool, ...]        # ground-truth shard liveness
    routed: Tuple[bool, ...]       # the router's liveness view
    replicas: np.ndarray           # i32[global_buckets] secondary shard
    #                                per bucket; n_shards = unreplicated
    seed: int
    pool: ranks.Pool               # this process's share of the pool

    @classmethod
    def make(cls, cfg: CacheConfig, n_shards: int = 1,
             lanes_per_shard: int = 8, seed: int = 0,
             device=None, group=None) -> "Cluster":
        """A sharded cache cluster on ``device`` (default: the card;
        raises without one).  ``cfg`` describes the global pool; each
        shard runs a local cache over 1/n_shards of its buckets and
        capacity.  ``group``: a ``torch.distributed`` process group
        (``nccl``, one card a rank, or ``gloo``) whose R ranks, R
        dividing ``n_shards``, each hold S/R shards; every rank calls
        this and every later method alike.  None: every shard here."""
        device = on_device(device, "Cluster.make")
        pool = ranks.make_pool(group, n_shards, device)
        device, dm, local = _dm_make_impl(cfg, n_shards, lanes_per_shard,
                                          seed, device, pool)
        return cls(device=device, cfg=cfg, local=local, dm=dm,
                   n_shards=n_shards, lanes_per_shard=lanes_per_shard,
                   alive=(True,) * n_shards, routed=(True,) * n_shards,
                   replicas=np.full((cfg.n_buckets,), n_shards, np.int32),
                   seed=seed, pool=pool)

    # Handle-shaped views, so ExecResult's properties work on a Cluster.

    @property
    def state(self):
        return self.dm.state

    @property
    def clients(self):
        return self.dm.clients

    @property
    def stats(self):
        """Counters summed over every shard (of every rank); the per-shard
        ones of this rank's block are on ``cluster.dm.stats``.  Over
        ranks this is an ``all_reduce``: every rank must read it, and
        before the group is destroyed, or the readers wait (or fail) in
        the collective."""
        return OpStats(*self.pool.sum_(torch.stack(
            [f.sum() for f in self.dm.stats])))

    def membership(self) -> Membership:
        """(alive, routed, replicas) as the routing maps: identity owners
        for routed home shards; a bucket whose home is marked failed
        promotes its live secondary, else goes to the rendezvous winner
        among the routed survivors; dead or now-primary secondaries are
        scrubbed."""
        S, GB = self.n_shards, self.cfg.n_buckets
        lb = self.local.n_buckets
        routed = np.asarray(self.routed, bool)
        prim = np.arange(GB, dtype=np.int32) // lb
        rep = np.asarray(self.replicas, np.int32)
        rep_live = (rep < S) & routed[np.where(rep < S, rep, 0)]
        dead_home = ~routed[prim]
        if dead_home.any() and routed.any():
            sc = _rendezvous_scores(GB, S)
            sc[:, ~routed] = -1
            rv = np.argmax(sc, axis=1).astype(np.int32)
            prim = np.where(dead_home & rep_live, rep,
                            np.where(dead_home, rv, prim)).astype(np.int32)
        rep = np.where(rep_live & (rep != prim), rep, S).astype(np.int32)
        return Membership(
            primary=_as_tensor(prim, self.device),
            replica=_as_tensor(rep, self.device),
            serving=_as_tensor(np.asarray(self.alive, bool), self.device,
                               torch.bool))

    def replica_map(self) -> np.ndarray:
        """i32[global_buckets] secondary shard per bucket (n_shards =
        unreplicated); a copy."""
        return np.asarray(self.replicas, np.int32).copy()

    def with_replicas(self, replicas) -> "Cluster":
        """Install an explicit per-bucket secondary map (i32[GB];
        ``n_shards`` for no replica)."""
        rep = np.asarray(replicas, np.int32)
        if rep.shape != (self.cfg.n_buckets,):
            raise ValueError(
                f"replica map must be [{self.cfg.n_buckets}], "
                f"got {rep.shape}")
        if ((rep < 0) | (rep > self.n_shards)).any():
            raise ValueError("replica shard ids must be in [0, n_shards]")
        return self._replace(replicas=rep.copy())

    def elect_replicas(self, loads, n_hot: int) -> "Cluster":
        """Replicate the ``n_hot`` hottest buckets of a per-global-bucket
        load vector: each secondary is the rendezvous winner among the
        routed shards other than the bucket's home.  Buckets with no
        positive load get none; the rest are unreplicated."""
        S, GB = self.n_shards, self.cfg.n_buckets
        lb = self.local.n_buckets
        loads = np.asarray(loads, np.float64)
        if loads.shape != (GB,):
            raise ValueError(f"loads must be [{GB}], got {loads.shape}")
        routed = np.asarray(self.routed, bool)
        rep = np.full((GB,), S, np.int32)
        n_hot = int(min(n_hot, GB))
        if n_hot > 0 and routed.sum() >= 2:
            # The hottest loads first.  dittolint: disable=DL003
            hot = np.argsort(-loads, kind="stable")[:n_hot]
            hot = hot[loads[hot] > 0]
            prim = (hot // lb).astype(np.int32)
            sc = _rendezvous_scores(GB, S)[hot]
            sc[:, ~routed] = -1
            sc[np.arange(hot.size), prim] = -1
            best = np.argmax(sc, axis=1).astype(np.int32)
            ok = sc[np.arange(hot.size), best] >= 0
            rep[hot[ok]] = best[ok]
        return self._replace(replicas=rep)

    def with_capacity(self, new_global_capacity: int) -> "Cluster":
        """One capacity write per shard, no migration."""
        from repro_torch.elastic.resize import _set_capacity_impl
        return self._replace(dm=_set_capacity_impl(
            self.dm, new_global_capacity, self.n_shards))

    def drain_to(self, new_global_capacity: int, *, drain: bool = True,
                 batch_per_shard: int = 64, max_steps: int = 256):
        """Online resize with the shrink drain (``resize_memory``).
        Returns (cluster, ResizeReport)."""
        from repro_torch.elastic.resize import resize_memory
        dm, report = resize_memory(
            self.local, self.dm, new_global_capacity, drain=drain,
            batch_per_shard=batch_per_shard, max_steps=max_steps,
            pool=self.pool)
        return self._replace(dm=dm), report

    def with_tenant_budgets(self, budgets) -> "Cluster":
        """Rewrite the per-tenant budgets (global units, split exactly)."""
        from repro_torch.elastic.resize import set_tenant_budgets
        return self._replace(dm=set_tenant_budgets(
            self.dm, budgets, self.n_shards, pool=self.pool))

    def with_lanes(self, new_lanes_per_shard: int):
        """Change the client lanes per shard (``resize_lanes``; new lanes
        seeded with ``seed + 1``).  Returns (cluster, ResizeReport).  A
        new width is a new DM step shape, so the next ``execute`` at it
        captures one new graph."""
        from repro_torch.elastic.resize import resize_lanes
        dm, report = resize_lanes(self.local, self.dm, new_lanes_per_shard,
                                  seed=self.seed + 1, pool=self.pool)
        return self._replace(dm=dm,
                             lanes_per_shard=new_lanes_per_shard), report

    def inject_failure(self, k: int) -> "Cluster":
        """Ground-truth loss of shard k: its state is wiped (by the rank
        that holds it) and it stops serving; the router still believes
        it up until ``mark_failed`` (the detection gap the failover run
        measures)."""
        from repro_torch.elastic.resize import fail_wipe_shard
        if not (0 <= k < self.n_shards):
            raise ValueError(f"shard {k} out of range")
        alive = list(self.alive)
        alive[k] = False
        return self._replace(
            dm=fail_wipe_shard(self.local, self.dm, k, pool=self.pool),
            alive=tuple(alive))

    def mark_failed(self, k: int) -> "Cluster":
        """Detection: stop routing to shard k."""
        if not (0 <= k < self.n_shards):
            raise ValueError(f"shard {k} out of range")
        routed = list(self.routed)
        routed[k] = False
        return self._replace(routed=tuple(routed))

    def recover(self, k: int, *, rewarm: bool = True,
                max_objects: int = 512):
        """Shard k serves and is routed again and, with ``rewarm``, takes
        back the hottest of its objects the survivors absorbed
        (``resize.rewarm_shard``).  Returns (cluster, ResizeReport)."""
        from repro_torch.elastic.resize import ResizeReport, rewarm_shard
        if not (0 <= k < self.n_shards):
            raise ValueError(f"shard {k} out of range")
        alive = list(self.alive)
        routed = list(self.routed)
        alive[k] = True
        routed[k] = True
        c = self._replace(alive=tuple(alive), routed=tuple(routed))
        if not rewarm:
            return c, ResizeReport(0, 0, 0, 0)
        dm, report = rewarm_shard(c.local, c.dm, k, max_objects=max_objects,
                                  pool=c.pool)
        return c._replace(dm=dm), report

    def execute(self, keys, is_write=None, obj_size=None, tenant=None,
                route_factor: int = 4):
        """Run a [T, S*lanes] (or [NG, G, S*lanes]) request sequence under
        this membership (``dm_execute``).  Returns (cluster, hits), hits a
        bool tensor of the keys' shape.  On the card the group step is
        captured once per (local config, lanes, route capacity) and
        replayed; a membership change only changes the routed inputs."""
        dev = self.device
        dm, hits = dm_execute(
            self.local, self.dm, _as_tensor(keys, dev),
            _as_tensor(is_write, dev, torch.bool),
            _as_tensor(obj_size, dev), _as_tensor(tenant, dev),
            route_factor=route_factor, member=self.membership(),
            pool=self.pool)
        return self._replace(dm=dm), hits


# Free-function spellings of the handle's mutators (same contract).

def with_capacity(cluster: Cluster, new_global_capacity: int) -> Cluster:
    return cluster.with_capacity(new_global_capacity)


def with_tenant_budgets(cluster: Cluster, budgets) -> Cluster:
    return cluster.with_tenant_budgets(budgets)


def with_lanes(cluster: Cluster, new_lanes_per_shard: int):
    return cluster.with_lanes(new_lanes_per_shard)


def mark_failed(cluster: Cluster, k: int) -> Cluster:
    return cluster.mark_failed(k)


def replica_map(cluster: Cluster) -> np.ndarray:
    return cluster.replica_map()
