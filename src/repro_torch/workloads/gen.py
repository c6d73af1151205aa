"""Workload generators (paper §5.1): YCSB with a scrambled zipfian key
distribution (theta=0.99; the paper uses 10M keys), ``interleave``,
which shapes a flat stream into [T, C] concurrent-client steps, the
expert-friendly streams (``lru_friendly``, ``scan_polluted_zipf``) and
their changing and mixed forms (``changing_workload``,
``loop_window``, ``mixed_apps``), the tenant workloads and their mix
(``flash_crowd``, ``shifting_zipf``, ``tenant_mix``) and the sized
streams (``object_sizes``, ``sized_zipfian``), and the DM placement
helpers (``shard_of``, ``keys_owned_by``, ``failover_trace``).

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


def lru_friendly(n_requests: int, n_keys: int = 50_000, window: int = 512,
                 p_reuse: float = 0.9, seed: int = 0) -> np.ndarray:
    """Sliding-window temporal locality: LRU ≫ LFU."""
    rng = np.random.default_rng(seed)
    out = np.empty(n_requests, np.uint32)
    recent = np.zeros(window, np.uint32)
    filled = 0
    nxt = 1
    reuse = rng.random(n_requests)
    pick = rng.integers(0, window, n_requests)
    for i in range(n_requests):
        if filled > 0 and reuse[i] < p_reuse:
            k = recent[pick[i] % filled]
        else:
            k = nxt
            nxt = (nxt % n_keys) + 1
        out[i] = k
        recent[i % window] = k
        filled = min(filled + 1, window)
    return out


def scan_polluted_zipf(n_requests: int, hot_keys: int = 4_000,
                       theta: float = 1.1, scan_frac: float = 0.3,
                       scan_len: int = 2_000, seed: int = 0) -> np.ndarray:
    """Stable zipfian core + one-touch scan bursts: LFU ≫ LRU."""
    rng = np.random.default_rng(seed)
    p = _zipf_probs(hot_keys, theta)
    out = np.empty(n_requests, np.uint32)
    i = 0
    scan_base = hot_keys + 1
    while i < n_requests:
        if rng.random() < scan_frac:
            n = min(scan_len, n_requests - i)
            out[i:i + n] = scan_base + np.arange(n, dtype=np.uint32)
            scan_base += n
            i += n
        else:
            n = min(scan_len, n_requests - i)
            out[i:i + n] = rng.choice(hot_keys, size=n, p=p).astype(np.uint32) + 1
            i += n
    return out


lfu_friendly = scan_polluted_zipf


def changing_workload(n_requests: int, n_phases: int = 4, seed: int = 0,
                      key_offset: int = 0) -> np.ndarray:
    """Phases alternating LRU-friendly / LFU-friendly (Fig. 19 shape)."""
    per = n_requests // n_phases
    parts = []
    for ph in range(n_phases):
        if ph % 2 == 0:
            parts.append(lru_friendly(per, seed=seed + ph))
        else:
            parts.append(lfu_friendly(per, seed=seed + ph) + np.uint32(100_000))
    out = np.concatenate(parts)[:n_requests]
    return (out + np.uint32(key_offset)).astype(np.uint32)


def loop_window(n_requests: int, capacity: int, n_phases: int = 6,
                window: int = 700, p_reuse: float = 0.9,
                seed: int = 0) -> np.ndarray:
    """Changing workload with strong expert divergence (Fig. 19 shape):
    cyclic-loop phases (LRU-pathological, frequency helps) alternating with
    fresh sliding-window phases (recency helps, stale frequencies mislead
    LFU). Adaptive caching should beat BOTH single experts here."""
    rng = np.random.default_rng(seed)
    parts = []
    base = 1_000_000
    for ph in range(n_phases):
        n = n_requests // n_phases
        if ph % 2 == 0:
            loop_keys = int(capacity * 4 // 3)
            parts.append((np.arange(n, dtype=np.uint32) % loop_keys) + 1)
        else:
            out = np.empty(n, np.uint32)
            recent = np.zeros(window, np.uint32)
            filled, nxt = 0, base
            base += 300_000
            ru = rng.random(n)
            pk = rng.integers(0, window, n)
            for i in range(n):
                if filled and ru[i] < p_reuse:
                    k = recent[pk[i] % filled]
                else:
                    k = nxt
                    nxt += 1
                out[i] = k
                recent[i % window] = k
                filled = min(filled + 1, window)
            parts.append(out)
    return np.concatenate(parts)


def mixed_apps(n_requests: int, n_clients: int, lru_fraction: float,
               seed: int = 0) -> np.ndarray:
    """[T, C] tensor: a fraction of clients runs an LRU-friendly app, the
    rest an LFU-friendly app with a disjoint key space (Figs. 3/20)."""
    n_lru = int(round(lru_fraction * n_clients))
    T = n_requests // n_clients
    cols = []
    for c in range(n_clients):
        if c < n_lru:
            cols.append(lru_friendly(T, seed=seed * 131 + c))
        else:
            cols.append(lfu_friendly(T, seed=seed * 131 + c) + np.uint32(500_000))
    return np.stack(cols, axis=1)


def flash_crowd(n_requests: int, hot_keys: int = 512, theta: float = 1.1,
                start_frac: float = 0.5, stop_frac: float = 1.0,
                background_every: int = 8, background_keys: int = 20_000,
                seed: int = 0) -> np.ndarray:
    """A tenant that idles, then stampedes (the cloud-service flash
    crowd): before ``start_frac`` of the trace it issues sparse uniform
    background traffic (one real request every ``background_every``
    slots, the rest no-op pads), then floods dense zipfian traffic over
    a small hot set until ``stop_frac``.  The burst is what stresses
    isolation: un-partitioned, it evicts every other tenant's working
    set; partitioned, it can only churn its own budget."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n_requests, np.uint32)
    t0 = int(n_requests * start_frac)
    t1 = min(n_requests, int(n_requests * stop_frac))
    bg = np.arange(n_requests) % background_every == 0
    n_bg = int(bg[:t0].sum())
    out[:t0][bg[:t0]] = rng.integers(
        hot_keys + 1, hot_keys + 1 + background_keys, n_bg).astype(np.uint32)
    n_burst = t1 - t0
    if n_burst > 0:
        p = _zipf_probs(hot_keys, theta)
        out[t0:t1] = (rng.choice(hot_keys, size=n_burst, p=p) + 1).astype(
            np.uint32)
    if t1 < n_requests:  # post-burst: back to background
        tail = bg[t1:]
        out[t1:][tail] = rng.integers(
            hot_keys + 1, hot_keys + 1 + background_keys,
            int(tail.sum())).astype(np.uint32)
    return out


def shifting_zipf(n_requests: int, n_keys: int = 4_000, n_phases: int = 4,
                  theta: float = 1.0, seed: int = 0) -> np.ndarray:
    """Zipfian traffic whose hot set rotates every phase (the shifting
    tenant): same marginal skew, disjointly permuted rank->key maps, so
    a cache that adapted to one phase's hot set re-learns on the next."""
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys, theta)
    out = np.empty(n_requests, np.uint32)
    per = max(1, n_requests // n_phases)
    for ph in range((n_requests + per - 1) // per):
        lo, hi = ph * per, min((ph + 1) * per, n_requests)
        perm = rng.permutation(n_keys)
        ranks = rng.choice(n_keys, size=hi - lo, p=p)
        out[lo:hi] = (perm[ranks] + 1).astype(np.uint32)
    return out


# Per-tenant workload kinds for `tenant_mix`.
_TENANT_KINDS = ("zipf", "scan", "flash", "shift")


def tenant_mix(n_requests: int, n_clients: int, specs, seed: int = 0,
               key_stride: int = 1 << 21):
    """Build a multi-tenant [T, C] request mix (DESIGN.md §11).

    Each spec describes one tenant: a kind string or a dict
    ``{"kind": ..., "lanes": int, "max_blocks": int, **kind_kwargs}``.
    Kinds: ``zipf`` (steady zipfian service), ``scan`` (one-touch scan
    bursts over a zipf core, LFU-friendly), ``flash`` (idle ->
    flash-crowd stampede), ``shift`` (hot set rotates per phase).
    Client lanes are assigned to tenants contiguously (spec order);
    key spaces are disjoint (tenant t's keys offset by ``t * key_stride``).

    Returns:
      (keys u32[T, C], tenants u32[T, C], sizes u32[T, C]) — sizes are 1
      block unless a spec sets ``max_blocks`` (then hash-sized per key).
    """
    specs = [dict(kind=s) if isinstance(s, str) else dict(s) for s in specs]
    for s in specs:
        if s.get("kind") not in _TENANT_KINDS:
            raise ValueError(
                f"unknown tenant kind {s.get('kind')!r}; "
                f"expected one of {_TENANT_KINDS}")
    auto = max(1, n_clients // len(specs))
    lanes = [int(s.pop("lanes", auto)) for s in specs]
    if sum(lanes) != n_clients:
        raise ValueError(
            f"tenant lane counts {lanes} must sum to n_clients={n_clients}")
    T = n_requests // n_clients
    key_cols, ten_cols, size_cols = [], [], []
    for tid, (s, nl) in enumerate(zip(specs, lanes)):
        kind = s.pop("kind")
        max_blocks = int(s.pop("max_blocks", 1))
        n = T * nl
        sd = seed * 1009 + tid
        if kind == "zipf":
            flat = zipfian(n, s.pop("n_keys", 4_000),
                           theta=s.pop("theta", 0.99), seed=sd, **s)
        elif kind == "scan":
            flat = scan_polluted_zipf(n, seed=sd, **s)
        elif kind == "flash":
            flat = flash_crowd(n, seed=sd, **s)
        else:  # shift
            flat = shifting_zipf(n, seed=sd, **s)
        # Disjoint key spaces; key 0 (no-op idle slots) stays 0.
        flat = np.where(flat != 0,
                        flat + np.uint32(tid * key_stride), 0).astype(
            np.uint32)
        k2 = flat[:T * nl].reshape(T, nl)
        key_cols.append(k2)
        ten_cols.append(np.full((T, nl), tid, np.uint32))
        if max_blocks > 1:
            sz = object_sizes(k2.reshape(-1), max_blocks=max_blocks,
                              seed=sd + 7).reshape(T, nl)
            sz = np.where(k2 != 0, sz, 1).astype(np.uint32)
        else:
            sz = np.ones((T, nl), np.uint32)
        size_cols.append(sz)
    return (np.concatenate(key_cols, axis=1),
            np.concatenate(ten_cols, axis=1),
            np.concatenate(size_cols, axis=1))


def object_sizes(keys: np.ndarray, max_blocks: int = 8, seed: int = 3) -> np.ndarray:
    """Deterministic pseudo-random size (in 64B blocks) per key."""
    x = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed)
    return ((x >> np.uint64(33)) % np.uint64(max_blocks) + np.uint64(1)).astype(np.uint32)


def sized_zipfian(n_requests: int, n_keys: int, theta: float = 0.99,
                  seed: int = 0, size_dist: str = "zipf",
                  max_blocks: int = 32, alpha: float = 0.8):
    """Zipfian key stream with per-key value sizes (paper §7 analogues).

    The Twitter / IBM object-store traces share a shape the uniform-size
    YCSB streams cannot express: the request-dominating hot keys are
    *small* while the byte-dominating cold tail is *large* — exactly the
    regime where the size-aware priority functions (size/GDS/GDSF, Table
    3) beat size-oblivious LRU on **byte** hit rate under a byte budget.

    Args:
      size_dist: ``"zipf"`` — sizes grow with popularity rank:
        ``blocks = 1 + round((max_blocks-1) * ((rank+1)/n_keys)**alpha)``
        (rank 0 = hottest key), deterministic per key; ``"uniform"`` —
        hash-uniform in [1, max_blocks], independent of popularity (the
        control arm: any byte-hit-rate gap vanishes here).
    Returns:
      (keys u32[N], sizes u32[N]); sizes are a pure function of the key.
    """
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys, theta)
    ranks = rng.choice(n_keys, size=n_requests, p=p)
    perm = rng.permutation(n_keys)           # scrambled key ids
    keys = (perm[ranks] + 1).astype(np.uint32)
    if size_dist == "uniform":
        sizes = object_sizes(keys, max_blocks=max_blocks, seed=seed + 1)
    elif size_dist == "zipf":
        frac = (ranks + 1.0) / float(n_keys)
        sizes = (1 + np.round((max_blocks - 1) * frac ** alpha)).astype(
            np.uint32)
    else:
        raise ValueError(f"unknown size_dist {size_dist!r}")
    return keys, sizes


def _mix32(x: np.ndarray) -> np.ndarray:
    """Host-side splitmix32 (``core.hashing.splitmix32``) in uint64
    arithmetic, so numpy never warns on the intended wraparound."""
    M = np.uint64(0xFFFFFFFF)
    x = np.asarray(x, np.uint64) & M
    x = (x + np.uint64(0x9E3779B9)) & M
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & M
    x = ((x ^ (x >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & M
    x = x ^ (x >> np.uint64(16))
    return (x & M).astype(np.uint32)


def shard_of(keys: np.ndarray, n_shards: int, n_buckets: int) -> np.ndarray:
    """Home shard per key under the DM placement: hash -> global bucket
    -> contiguous bucket range per shard (``dm/sharded_cache.py``)."""
    kh = _mix32(np.asarray(keys, np.uint32))
    bucket = (kh % np.uint32(n_buckets)).astype(np.int64)
    return (bucket // (n_buckets // n_shards)).astype(np.int32)


def keys_owned_by(shard: int, n: int, n_shards: int, n_buckets: int,
                  seed: int = 0) -> np.ndarray:
    """``n`` distinct uint32 keys homed on ``shard``: a deterministic
    rejection scan from a seeded offset."""
    start = 1 + (seed % 997) * 1_000_003
    out = np.empty(0, np.uint32)
    span = max(64 * n * n_shards, 1024)
    while out.size < n:
        cand = np.arange(start, start + span, dtype=np.uint64)
        cand = (cand % np.uint64(2**32 - 1) + np.uint64(1)).astype(np.uint32)
        cand = cand[shard_of(cand, n_shards, n_buckets) == shard]
        out = np.concatenate([out, cand])
        start += span
    return out[:n]


def failover_trace(n_steps: int, lanes_per_shard: int, n_shards: int,
                   n_buckets: int, *, hot_shard: int = 0,
                   hot_fraction: float = 0.5, n_hot: int = 64,
                   n_keys: int = 4096, theta: float = 0.99,
                   seed: int = 0) -> np.ndarray:
    """[T, n_shards*lanes] trace with ``hot_fraction`` of its requests on
    a zipfian core homed entirely on ``hot_shard`` (the shard a failover
    run kills), the rest a scrambled zipfian over all shards."""
    rng = np.random.default_rng(seed)
    L = n_shards * lanes_per_shard
    N = n_steps * L
    hot_keys = keys_owned_by(hot_shard, n_hot, n_shards, n_buckets,
                             seed=seed)
    hot = hot_keys[rng.choice(n_hot, size=N, p=_zipf_probs(n_hot, theta))]
    cold = zipfian(N, n_keys, theta, seed + 1)
    keys = np.where(rng.random(N) < hot_fraction, hot, cold)
    return keys.astype(np.uint32).reshape(n_steps, L)
