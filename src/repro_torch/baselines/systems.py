"""Analytical system models for the paper's comparison systems: the
port's copy of ``repro/baselines/systems.py``'s calibration constants
(``Cluster``, ``CLUSTER``), ``DittoModel`` (the throughput model the
``run_scenario`` reports per window) and the comparison systems'
models: ``CliqueMapModel``, ``ShardLRUModel`` and ``RedisModel``.

The paper's throughput and elasticity figures measure RDMA hardware the
repo does not have; they are reproduced as cost models calibrated to the
paper's testbed (100 Gbps ConnectX-6, a one-core memory node), driven
for Ditto by the measured remote-op counts of the implementation
(``OpStats``).  Calibration anchors, from the paper's own numbers: Ditto
YCSB-C saturates at 13.2 Mops, bound by the memory node's RNIC message
rate (~3.1 messages an op pins it at ~41 M msg/s); CliqueMap YCSB-C
with a one-core memory node ~1.5 Mops; Redis, 32 one-core shards ~2.5
Mops under zipfian skew, and a 32 -> 64 node rescale migrates half of
10M objects in ~5.3 minutes.  CliqueMap's Sets are one-RTT server RPCs;
Shard-LRU holds a remote lock across its list edits.

Host numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cluster:
    rnic_msg_rate: float = 41e6      # MN RNIC verbs/sec (message-rate bound)
    rnic_bw: float = 12.5e9          # MN RNIC bytes/sec (100 Gbps ConnectX-6)
    rtt: float = 2.25e-6             # one-sided RDMA round trip (s)
    client_overhead: float = 1.2e-6  # client-side CPU per op (s)
    mn_core_set_rate: float = 1.2e6  # CliqueMap Set RPCs /s /MN-core
    mn_core_merge_rate: float = 1.5e6   # access-info merges /s /MN-core
    redis_core_rate: float = 0.16e6  # Redis ops/s/core (256B, incl. proto)
    zipf_hottest_share: float = 0.065   # hottest of 32 shards, zipf(0.99)
    migration_keys_per_s: float = 15_700.0
    miss_penalty: float = 500e-6     # storage fetch on miss (s)


CLUSTER = Cluster()


# ----------------------------------------------------------------------
# Ditto: message-rate bound from measured OpStats.
# ----------------------------------------------------------------------

class DittoModel:
    """Throughput from measured messages/op + serial RTTs per op, plus a
    payload-size-dependent bandwidth bound from measured wire bytes."""

    def __init__(self, cluster: Cluster = CLUSTER):
        self.c = cluster

    def msgs_per_op(self, stats) -> float:
        ops = float(stats.gets + stats.sets)
        msgs = float(stats.rdma_read + stats.rdma_write + stats.rdma_cas
                     + stats.rdma_faa + stats.rpc)
        return msgs / max(ops, 1.0)

    def bytes_per_op(self, stats) -> float:
        """Measured wire bytes per executed op: object payloads move at
        their real size (64B blocks), so big-value traces saturate RNIC
        *bandwidth* before they saturate its message rate. If EITHER i32
        counter wrapped (see OpStats), the measurement is garbage:
        disable the bound (return 0) rather than cap throughput at an
        arbitrary wrong value."""
        ops = float(stats.gets + stats.sets)
        rd = float(getattr(stats, "rdma_read_bytes", 0))
        wr = float(getattr(stats, "rdma_write_bytes", 0))
        if rd < 0 or wr < 0:
            return 0.0
        return (rd + wr) / max(ops, 1.0)

    def serial_rtts(self, is_write_frac: float = 0.0) -> float:
        # GET: bucket read -> object read (metadata update is async).
        # SET: bucket read -> object write -> slot CAS (paper §5.3: 3 RTTs).
        return 2.0 * (1 - is_write_frac) + 3.0 * is_write_frac

    def throughput(self, n_clients: int, stats, is_write_frac: float = 0.0,
                   hit_rate: float = 1.0) -> float:
        lat = (self.serial_rtts(is_write_frac) * self.c.rtt
               + self.c.client_overhead
               + (1.0 - hit_rate) * self.c.miss_penalty)
        client_bound = n_clients / lat
        # Coroutine-scheduling efficiency loss on large CNs (paper §5.2).
        eff = 0.93 ** max(0, np.log2(max(n_clients, 1) / 32.0))
        rnic_bound = self.c.rnic_msg_rate / max(self.msgs_per_op(stats), 1e-9)
        # ~400B/op at 1-block objects: far from binding, so uniform-size
        # results are unchanged; 4KB payloads pin it at ~2.8 Mops.
        bw_bound = self.c.rnic_bw / max(self.bytes_per_op(stats), 1e-9)
        return min(client_bound * eff, rnic_bound, bw_bound)


# ----------------------------------------------------------------------
# CliqueMap: Gets are client RDMA reads; Sets + access-info merging are
# MN-CPU bound (the paper's core efficiency argument).
# ----------------------------------------------------------------------

class CliqueMapModel:
    def __init__(self, cluster: Cluster = CLUSTER, mn_cores: int = 1):
        self.c = cluster
        self.mn_cores = mn_cores

    def throughput(self, n_clients: int, is_write_frac: float = 0.0,
                   hit_rate: float = 1.0) -> float:
        lat_get = 2 * self.c.rtt + self.c.client_overhead
        lat_set = 1 * self.c.rtt + self.c.client_overhead  # 1-RTT RPC
        lat = ((1 - is_write_frac) * lat_get + is_write_frac * lat_set
               + (1.0 - hit_rate) * self.c.miss_penalty)
        client_bound = n_clients / lat
        # Every Set is a server RPC; every Get contributes one access-info
        # record that the MN CPU must merge (periodic sync).
        per_op_cpu = (is_write_frac / self.c.mn_core_set_rate
                      + (1 - is_write_frac) / self.c.mn_core_merge_rate)
        cpu_bound = self.mn_cores / max(per_op_cpu, 1e-12)
        return min(client_bound, cpu_bound)


# ----------------------------------------------------------------------
# Shard-LRU: remote lock-protected linked lists (Fig. 2 strawman).
# ----------------------------------------------------------------------

class ShardLRUModel:
    def __init__(self, cluster: Cluster = CLUSTER, n_shards: int = 32,
                 backoff: float = 5e-6):
        self.c = cluster
        self.n_shards = n_shards
        self.backoff = backoff

    def throughput(self, n_clients: int, is_write_frac: float = 0.0) -> float:
        # Critical section: CAS lock + 2 list-pointer updates + unlock write.
        crit = 4 * self.c.rtt
        lat = crit + 2 * self.c.rtt + self.c.client_overhead  # + data access
        # Hottest shard serializes its zipfian share of all ops.
        shard_bound = (1.0 / crit) / self.c.zipf_hottest_share
        client_bound = n_clients / lat
        # Lock-fail CAS retries waste RNIC messages once demand > capacity:
        demand = min(client_bound, 20e6)
        util = demand * self.c.zipf_hottest_share * crit
        if util > 1.0:
            # retries (bounded by the 5us backoff) flood the RNIC
            retry_msgs = demand * min(util - 1.0, 1.0) * (crit / self.backoff)
            rnic_left = max(self.c.rnic_msg_rate - retry_msgs, self.c.rnic_msg_rate * 0.02)
            rnic_bound = rnic_left / 6.0
            return min(client_bound, shard_bound, rnic_bound)
        return min(client_bound, shard_bound)


# ----------------------------------------------------------------------
# Redis: monolithic sharded VMs — elasticity timeline (Figs. 1/13).
# ----------------------------------------------------------------------

class RedisModel:
    def __init__(self, cluster: Cluster = CLUSTER, n_keys: int = 10_000_000):
        self.c = cluster
        self.n_keys = n_keys

    def steady_throughput(self, n_nodes: int) -> float:
        # Zipfian skew: the hottest shard's single core is the bottleneck.
        hottest = self.c.zipf_hottest_share * (32.0 / n_nodes)
        return min(self.c.redis_core_rate / max(hottest, 1.0 / n_nodes),
                   n_nodes * self.c.redis_core_rate)

    def migration_seconds(self, frac_moved: float) -> float:
        return self.n_keys * frac_moved / self.c.migration_keys_per_s

    def migration_bytes(self, frac_moved: float, obj_bytes: int = 256) -> int:
        """Bytes resharding moves over the network (paper: half of 10M
        256B objects on a 32->64 rescale) — the contrast line for
        ``run_scenario``'s measured migration_bytes for Ditto."""
        return int(self.n_keys * frac_moved * obj_bytes)

    def timeline(self, events, horizon_s: float, dt: float = 1.0):
        """events: [(t, n_nodes_new)] resize requests. Returns (t, tput,
        nodes_billed) arrays with migration-time penalties applied."""
        t = np.arange(0.0, horizon_s, dt)
        tput = np.zeros_like(t)
        billed = np.zeros_like(t)
        cur = events[0][1]
        mig_until = -1.0
        prev = cur
        for i, ti in enumerate(t):
            for (te, n_new) in events:
                if abs(ti - te) < dt / 2 and n_new != cur:
                    frac = abs(n_new - cur) / max(cur, n_new)
                    mig_until = ti + self.migration_seconds(frac * 0.5)
                    prev, cur = cur, n_new
            migrating = ti < mig_until
            # Throughput reaches the new steady state only after migration;
            # resource reclamation (billing) is also delayed by migration.
            eff_nodes = cur if not migrating else min(prev, cur)
            tp = self.steady_throughput(eff_nodes)
            if migrating:
                tp *= 0.93  # up-to-7% drop during data movement
            tput[i] = tp
            billed[i] = max(prev, cur) if migrating else cur
        return t, tput, billed
