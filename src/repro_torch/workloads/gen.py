"""Workload generators (paper §5.1): YCSB with a scrambled zipfian key
distribution (theta=0.99; the paper uses 10M keys), and ``interleave``,
which shapes a flat stream into [T, C] concurrent-client steps.

The port's own copy of the generators it needs from
``repro/workloads/gen.py``; the same seeds give identical arrays.  Keys
are uint32 >= 1 (0 is the no-op pad).
"""

from __future__ import annotations

import numpy as np


def _zipf_probs(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-theta)
    return p / p.sum()


def zipfian(n_requests: int, n_keys: int, theta: float = 0.99,
            seed: int = 0, scramble: bool = True) -> np.ndarray:
    """YCSB-style (scrambled) zipfian key stream."""
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys, theta)
    ranks = rng.choice(n_keys, size=n_requests, p=p)
    if scramble:
        perm = rng.permutation(n_keys)
        ranks = perm[ranks]
    return (ranks + 1).astype(np.uint32)


def ycsb(workload: str, n_requests: int, n_keys: int = 100_000,
         theta: float = 0.99, seed: int = 0):
    """YCSB core workloads. Returns (keys u32[N], is_write bool[N])."""
    rng = np.random.default_rng(seed + 17)
    keys = zipfian(n_requests, n_keys, theta, seed)
    w = workload.upper()
    if w == "A":
        is_write = rng.random(n_requests) < 0.5
    elif w == "B":
        is_write = rng.random(n_requests) < 0.05
    elif w == "C":
        is_write = np.zeros(n_requests, bool)
    elif w == "D":
        # 95% reads (latest-skewed), 5% inserts of fresh keys.
        is_write = rng.random(n_requests) < 0.05
        fresh = n_keys + 1 + np.arange(n_requests, dtype=np.uint32)
        keys = np.where(is_write, fresh, keys).astype(np.uint32)
    else:
        raise ValueError(f"unknown YCSB workload {workload!r}")
    return keys, is_write


def interleave(keys: np.ndarray, n_clients: int,
               is_write: np.ndarray | None = None):
    """Shape a flat stream into [T, C] concurrent-client steps.

    Clients execute disjoint round-robin shards of the stream concurrently —
    the paper's trace-sharding across client threads (§5.1), which is what
    makes the effective access pattern depend on the client count.
    """
    T = len(keys) // n_clients
    k = keys[:T * n_clients].reshape(T, n_clients)
    if is_write is None:
        return k
    return k, is_write[:T * n_clients].reshape(T, n_clients)
