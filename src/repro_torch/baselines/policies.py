"""Exact-policy oracles (pure Python and numpy), the port's copy of
``repro/baselines/policies.py``.

These serve two roles:
  1. Baselines: CliqueMap's CM-LRU / CM-LFU maintain *precise* server-side
     caching structures, so their hit rates are those of the exact policies.
  2. Oracles: validate the Ditto cache on the card: with sampling (K→∞ or
     statistically at K=5), Ditto-LRU must approach exact LRU, etc.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict

import numpy as np


def simulate_policy(keys, capacity: int, policy: str = "lru") -> float:
    """Exact eviction policy over a flat key stream; returns hit rate."""
    if policy == "lru":
        return _sim_lru(keys, capacity, evict_oldest=True)
    if policy == "mru":
        return _sim_lru(keys, capacity, evict_oldest=False)
    if policy == "fifo":
        return _sim_fifo(keys, capacity)
    if policy == "lfu":
        return _sim_lfu(keys, capacity)
    raise ValueError(policy)


def _sim_lru(keys, capacity, evict_oldest=True) -> float:
    cache: OrderedDict = OrderedDict()
    hits = 0
    for k in keys:
        k = int(k)
        if k in cache:
            hits += 1
            cache.move_to_end(k)
        else:
            if len(cache) >= capacity:
                cache.popitem(last=not evict_oldest)
            cache[k] = True
    return hits / len(keys)


def _sim_fifo(keys, capacity) -> float:
    cache: OrderedDict = OrderedDict()
    hits = 0
    for k in keys:
        k = int(k)
        if k in cache:
            hits += 1
        else:
            if len(cache) >= capacity:
                cache.popitem(last=False)
            cache[k] = True
    return hits / len(keys)


def _sim_lfu(keys, capacity) -> float:
    """Exact LFU with insertion-order tiebreak (lazy heap)."""
    freq: dict = {}
    heap: list = []
    seq = 0
    hits = 0
    for k in keys:
        k = int(k)
        if k in freq:
            hits += 1
            freq[k] += 1
            heapq.heappush(heap, (freq[k], seq, k))
        else:
            if len(freq) >= capacity:
                while True:
                    f, _, victim = heapq.heappop(heap)
                    if victim in freq and freq[victim] == f:
                        del freq[victim]
                        break
            freq[k] = 1
            heapq.heappush(heap, (1, seq, k))
        seq += 1
    return hits / len(keys)


class PyDitto:
    """Sequential python reference of the Ditto semantics (sample-based
    eviction + optional LRU/LFU adaptivity with embedded history).

    Used as a behavioural oracle for the vectorized cache step: hit
    rates must agree statistically on the same workloads.
    """

    def __init__(self, capacity: int, n_samples: int = 5,
                 experts=("lru", "lfu"), hist_len: int | None = None,
                 learning_rate: float = 0.1, base_discount: float = 0.005,
                 seed: int = 0):
        self.capacity = capacity
        self.k = n_samples
        self.experts = experts
        self.hist_len = hist_len or capacity
        self.lam = learning_rate
        self.d = base_discount ** (1.0 / capacity)
        self.rng = np.random.default_rng(seed)
        self.md: dict = {}          # key -> [insert_ts, last_ts, freq]
        self.history: dict = {}     # key -> (hist_id, expert_bmap)
        self.hist_ctr = 0
        self.w = np.ones(len(experts)) / len(experts)
        self.clock = 0
        self.hits = 0
        self.ops = 0

    def _priority(self, e: str, md) -> float:
        ins, last, freq = md
        if e == "lru":
            return last
        if e == "lfu":
            return freq
        if e == "fifo":
            return ins
        if e == "mru":
            return -last
        raise ValueError(e)

    def access(self, key: int):
        self.clock += 1
        self.ops += 1
        key = int(key)
        if key in self.md:
            self.hits += 1
            m = self.md[key]
            m[1] = self.clock
            m[2] += 1
            return True
        # regret?
        if len(self.experts) > 1 and key in self.history:
            hid, bmap = self.history[key]
            age = self.hist_ctr - hid
            if age < self.hist_len:
                pen = self.d ** age
                for i in range(len(self.experts)):
                    if bmap >> i & 1:
                        self.w[i] *= np.exp(-self.lam * pen)
                self.w = np.maximum(self.w, 1e-4)
                self.w /= self.w.sum()
        # insert (read-through)
        if len(self.md) >= self.capacity:
            self._evict()
        self.md[key] = [self.clock, self.clock, 1]
        return False

    def _evict(self):
        keys = list(self.md.keys())
        idx = self.rng.integers(0, len(keys), self.k)
        sampled = [keys[i] for i in idx]
        cands = []
        for e in self.experts:
            pr = [self._priority(e, self.md[s]) for s in sampled]
            cands.append(sampled[int(np.argmin(pr))])
        e_choice = int(self.rng.choice(len(self.experts), p=self.w / self.w.sum()))
        victim = cands[e_choice]
        bmap = 0
        for i, c in enumerate(cands):
            if c == victim:
                bmap |= 1 << i
        del self.md[victim]
        if len(self.experts) > 1:
            self.history[victim] = (self.hist_ctr, bmap)
            self.hist_ctr += 1
            if len(self.history) > 2 * self.hist_len:
                cutoff = self.hist_ctr - self.hist_len
                self.history = {k: v for k, v in self.history.items()
                                if v[0] >= cutoff}

    def run(self, keys) -> float:
        for k in keys:
            self.access(k)
        return self.hits / max(self.ops, 1)
