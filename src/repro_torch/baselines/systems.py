"""Analytical system models for the paper's comparison systems: the
port's copy of ``repro/baselines/systems.py``'s calibration constants
(``Cluster``, ``CLUSTER``) and ``DittoModel``, the throughput model the
scenario driver reports per window.

The paper's throughput and elasticity figures measure RDMA hardware the
repo does not have; they are reproduced as cost models calibrated to the
paper's testbed (100 Gbps ConnectX-6, a one-core memory node), driven
for Ditto by the measured remote-op counts of the implementation
(``OpStats``).  Calibration anchors, from the paper's own numbers: Ditto
YCSB-C saturates at 13.2 Mops, bound by the memory node's RNIC message
rate (~3.1 messages an op pins it at ~41 M msg/s).

Host numpy only.  The other systems' models (``CliqueMapModel``,
``ShardLRUModel``, ``RedisModel``) are not in the port yet.
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
