"""Quickstart on PyTorch: the Ditto adaptive cache in 30 lines, on the
card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CacheConfig, execute, make
from repro_torch.workloads.gen import interleave, loop_window

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu")

CAP, CLIENTS = 1024, 8
trace = loop_window(40_000, CAP, seed=5)   # phases flip LRU<->LFU friendly

for experts in (("lru",), ("lfu",), ("lru", "lfu")):
    cfg = CacheConfig(n_buckets=512, assoc=8, capacity=CAP, experts=experts)
    res = execute(make(cfg, CLIENTS, device=dev), interleave(trace, CLIENTS))
    name = "Ditto(adaptive)" if len(experts) > 1 else f"Ditto-{experts[0].upper()}"
    w = np.round(res.state.weights.cpu().numpy(), 2)
    print(f"{name:16s} hit rate {res.hit_rate:.3f}" +
          (f"   final expert weights {w}" if len(experts) > 1 else ""))

print("\nThe adaptive cache should match or beat BOTH fixed policies "
      "on this phase-changing workload (paper Fig. 19).")
