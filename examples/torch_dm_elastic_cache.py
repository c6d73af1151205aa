"""Disaggregated-memory demo on PyTorch: the cache sharded over 8 memory
shards (a leading axis of the tables on one device, so no host-platform
flags are needed) with request routing, then driven through a full
elasticity timeline: memory grow (zero migration), compute grow/shrink
(lane width with client-state carry-over), memory shrink (online drain),
a workload shift, and a kill-a-shard failover leg (hot-bucket
replication, heartbeat detection and rewarming recovery, DESIGN.md §14)
through the elastic runtime's ``run_scenario`` and the ``dm.Cluster``
membership handle.  Client lanes run a small L0 near-cache
(``l0_entries=8``, DESIGN.md §15): the ``l0hit`` column counts requests
served entirely lane-locally; watch it dip in the failover window (the
epoch flush drops every lane's L0 wholesale) and climb back as the
lanes refill.  On the card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/torch_dm_elastic_cache.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import CacheConfig
from repro_torch.elastic import HealthMonitor, run_scenario
from repro_torch.workloads.gen import lru_friendly, zipfian

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu")

cfg = CacheConfig(n_buckets=1024, assoc=8, capacity=2048,
                  experts=("lru", "lfu"), l0_entries=8)

timeline = [
    (100, ("set_capacity", 4096)),       # memory grow: one scalar/shard
    (150, ("set_lanes", 16)),            # compute grow: 64 -> 128 lanes
    (250, ("set_lanes", 8)),             # compute shrink: decommission flush
    (300, ("set_capacity", 1024)),       # memory shrink: online drain
    (350, ("switch_workload", "shift")),  # recency-heavy phase
    (400, ("fail_shard", 3)),            # shard 3's DRAM is gone; routing
    #                                    # doesn't know yet: bounces until
    #                                    # the heartbeat monitor re-routes
    (475, ("recover_shard", 3)),         # replacement up: rewarm from the
    #                                    # survivors, route home again
]
res = run_scenario(
    cfg, zipfian(64 * 500, 20_000, seed=0), timeline,
    n_shards=8, lanes_per_shard=8, horizon=500, window=25,
    workloads={"shift": lru_friendly(20_000, seed=3)},
    health=HealthMonitor(8),             # missed-beat failover detection
    replicate_hot=64,                    # hot-bucket replica election
    device=dev)

print(f"{'window':>10} {'cap':>5} {'lanes':>5} {'hit%':>6} "
      f"{'cached':>6} {'KiB':>6} {'Mops':>6} {'l0hit':>5} {'drop':>5} "
      f"{'up':>3} events")
for w in res.windows:
    print(f"{w['t0']:>4}-{w['t1']:<5} {w['capacity']:>5} {w['lanes']:>5} "
          f"{100 * w['hit_rate']:>6.1f} {w['n_cached']:>6} "
          f"{w['bytes_cached'] // 1024:>6} "
          f"{w['tput_mops']:>6.2f} {w['l0_hits']:>5} {w['route_drops']:>5} "
          f"{sum(w['routed']):>3} "
          f"{','.join(w['events']) or '-'}")

resize_ev = [e for e in res.events
             if e["event"] in ("set_capacity", "set_lanes")]
mig = sum(e["report"]["migration_bytes"] for e in resize_ev)
rewarm = [e for e in res.events if e["event"] == "recover_shard"][0]
print(f"\nresize events: {len(resize_ev)}, migrated bytes (measured): {mig}")
print(f"failover: detected {[e['t'] for e in res.events if e['event'] == 'mark_failed']},"
      f" rewarmed {rewarm['report']['drained_objects']} objects "
      f"({rewarm['report']['migration_bytes']} bytes) on recovery")
per_shard = res.cluster.dm.state.bytes_cached.cpu().numpy()
print(f"final byte occupancy {per_shard.sum()} blocks <= budget "
      f"{res.windows[-1]['capacity']} blocks, per-shard: {per_shard}")
assert mig == 0, "capacity/lane resizes must not move data"
assert all(res.cluster.alive) and all(res.cluster.routed)
assert per_shard.sum() <= res.windows[-1]["capacity"] + 64
