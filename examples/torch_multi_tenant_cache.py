"""Multi-tenant demo on PyTorch (DESIGN.md §11): three tenants, a steady
zipfian service, a scan-heavy analytics job and a flash-crowd stampede,
share one byte-budgeted DM pool with hard per-tenant budgets,
per-tenant adaptive expert weights, and the elastic arbiter re-splitting
the global budget from measured per-tenant occupancy and hit-rate
windows.  On the card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/torch_multi_tenant_cache.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CacheConfig
from repro_torch.elastic import run_scenario
from repro_torch.elastic.controller import TenantArbiter
from repro_torch.workloads.gen import tenant_mix

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu")

LANES = 12
cfg = CacheConfig(n_buckets=512, assoc=8, capacity=768, n_tenants=3,
                  experts=("lru", "lfu"), sample_window=128)

keys, tenants, sizes = tenant_mix(
    LANES * 600, LANES,
    (dict(kind="zipf", n_keys=1_500, theta=0.9, lanes=4),
     dict(kind="scan", hot_keys=1_500, scan_len=500, lanes=2),
     dict(kind="flash", hot_keys=3_000, max_blocks=8, lanes=6)),
    seed=11)

res = run_scenario(
    cfg, keys.reshape(-1), [], n_shards=1, lanes_per_shard=LANES,
    horizon=600, window=50, sizes=sizes.reshape(-1),
    tenants=tenants.reshape(-1), arbiter=TenantArbiter(), device=dev)

names = ("steady", "scan", "flash")
print(f"{'window':>10} {'hit%':>6} " +
      " ".join(f"{n + ' blk/bud/hit%':>20}" for n in names) + "  events")
for w in res.windows:
    cells = " ".join(
        f"{w['tenant_blocks'][t]:>6}/{w['tenant_budget'][t]:>4}"
        f"/{100 * w['tenant_hit_rate'][t]:>5.1f}" for t in range(3))
    print(f"{w['t0']:>4}-{w['t1']:<5} {100 * w['hit_rate']:>6.1f} "
          f"{cells}  {','.join(w['events']) or '-'}")

splits = [e for e in res.events if e["event"] == "set_tenant_budgets"]
print(f"\narbiter re-splits: {len(splits)}"
      + (f", final {splits[-1]['arg']}" if splits else ""))
occ = res.dm.state.tenant_bytes.cpu().numpy().sum(axis=0)
bud = res.windows[-1]["tenant_budget"]
print(f"final per-tenant blocks {occ.tolist()} within budgets {bud}")
assert (occ <= np.asarray(bud)).all(), "tenant budgets must hold"
