"""Configurations of kind ``dm``: the pool as a ``repro_torch.dm.Cluster``
of memory shards with client lanes each, driven through
``Cluster.execute``, each call a [groups, rounds, shards x lanes] trace,
and the plain reference of the same call."""

from __future__ import annotations

import time

import numpy as np

from bench.kinds.pool import _flat, _leaves, _split
from bench.reference import cache as ref
from bench.reference import dm as ref_dm


class Program:
    """The system under test: a ``Cluster`` on ``device`` and the calls
    made on it."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch.core import CacheConfig
        from repro_torch.dm import Cluster
        cache = dict(config["cache"], experts=tuple(config["cache"]
                                                    ["experts"]))
        self.shards, self.lanes = int(config["shards"]), int(config["lanes"])
        self.rounds = int(config["rounds_per_group"])
        self.route_factor = int(config["route_factor"])
        self.cluster = Cluster.make(CacheConfig(**cache), self.shards,
                                    self.lanes, seed, device=device)
        self.drops = 0

    def call(self, keys, is_write, keep: bool = False) -> dict:
        t0 = time.perf_counter()
        k3 = keys.reshape(-1, self.rounds, keys.shape[1])
        w3 = is_write.reshape(k3.shape)
        self.cluster, hits = self.cluster.execute(
            k3, w3, route_factor=self.route_factor)
        hits = hits.cpu().numpy()
        t1 = time.perf_counter()
        # A DM step is a group on every shard; the call is its loop.
        rec = dict(t1=t1, requests=int((keys != 0).sum()),
                   rows=keys.shape[0], steps=k3.shape[0],
                   step_wall_s=t1 - t0,
                   failed=int(self.cluster.stats.route_drops) - self.drops)
        self.drops += rec["failed"]
        if keep:
            rec["out"] = dict(hits=hits, keys=k3, is_write=w3)
        return rec

    def leaves(self) -> dict:
        dm = self.cluster.dm
        return {**_leaves("state", dm.state), **_leaves("clients", dm.clients),
                **_leaves("stats", dm.stats)}

    def counters(self) -> dict:
        s = self.cluster.stats
        return {f: int(v) for f, v in zip(s._fields, s)}

    def release(self) -> None:
        self.cluster = None


def n_shards(config: dict) -> int:
    return int(config["shards"])


def align(config: dict) -> int:
    """Rows a call's row count is a multiple of."""
    return int(config["rounds_per_group"])


def width(config: dict) -> int:
    """Client lanes a call's rows hold: every shard's."""
    return int(config["shards"]) * int(config["lanes"])


def steps_of(record: dict):
    out = record["out"]
    return out["keys"], out["is_write"], out["hits"]


def reference_init(config: dict, seed: int, device) -> dict:
    cfg = ref.Config(**config["cache"])
    S = int(config["shards"])
    st = ref.init_state(cfg, device, n_shards=S)
    cl = ref.init_clients(cfg, S * int(config["lanes"]), seed, device)
    return _flat(st, cl, ref.init_stats(device, (S,)))


def reference_calls(config: dict, before: dict, calls: list,
                    device) -> tuple:
    """The reference's run of ``calls`` ((keys, is_write) each) from the
    state ``before``: (state after the last, each call's outputs)."""
    cfg = ref.Config(**config["cache"])
    st, cl, stats = _split(before, device)
    outs = []
    for keys, is_write in calls:
        k3 = keys.reshape(-1, int(config["rounds_per_group"]), keys.shape[1])
        w3 = is_write.reshape(k3.shape)
        st, cl, stats, hits = ref_dm.run_call(
            cfg, int(config["shards"]), int(config["lanes"]), st, cl, stats,
            k3, w3, int(config["route_factor"]))
        outs.append(dict(hits=hits))
    return _flat(st, cl, stats), outs


def compare_outputs(got: dict, want: dict) -> dict:
    from bench.harness.check import words_differ
    return dict(hit_flags=words_differ(np.asarray(got["hits"], bool),
                                       np.asarray(want["hits"], bool)))
