"""Ditto-managed KV page / prefix cache, as in
``repro/serve/page_cache.py``: the paper's technique as a serving
feature.

Each sequence's KV splits into fixed-size token pages in a global pool;
a request whose prompt shares a page-aligned prefix with earlier traffic
can skip prefill for the cached pages.  When the pool fills, the Ditto
core (``repro_torch.core.access``) picks the victim page by sampled,
expert-ranked eviction whose weights adapt to the request mix.  Pages
are keyed by a rolling hash of the page-aligned token prefix; the page's
pool index is the cached value.

The core's state lives on ``device`` (default: the card), where each
lookup runs the bucket probe, the hit-metadata update and the ranked
eviction as the hand-written kernels (``backend="fused"``); on the CPU
they run as their plain versions.  Free-pool bookkeeping is host-side
engine logic, and ``_reclaim`` reads the live keys back to the host, as
in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import (CacheConfig, access, init_cache, init_clients,
                              init_stats)
from repro_torch.core.types import on_device


def prefix_page_keys(tokens: np.ndarray, page_size: int) -> np.ndarray:
    """Rolling page-prefix hashes for one prompt: key_i identifies the
    content of pages [0..i] (prefix identity, not just page content)."""
    n_pages = len(tokens) // page_size
    keys = np.zeros(n_pages, np.uint32)
    h = 14695981039346656037  # FNV-1a over the rolling prefix
    for i in range(n_pages):
        page = tokens[i * page_size:(i + 1) * page_size]
        for t in page.tolist():
            h = ((h ^ int(t)) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
        keys[i] = np.uint32(((h >> 32) ^ h) & 0xFFFFFFFF)
    return np.maximum(keys, 1).astype(np.uint32)  # 0 is the no-op key


class DittoPageCache:
    """Engine-side page/prefix cache over the Ditto core.

    n_pages is the page-pool capacity; eviction decisions come from the
    adaptive sampled-eviction core."""

    def __init__(self, n_pages: int, page_size: int, *,
                 experts=("lru", "lfu"), n_clients: int = 1, seed: int = 0,
                 device=None):
        self.device = on_device(device, "DittoPageCache")
        n_buckets = max(64, int(2 * n_pages // 8))
        self.cfg = CacheConfig(
            n_buckets=n_buckets, assoc=8, capacity=n_pages,
            experts=experts, value_words=1)
        self.page_size = page_size
        self.state = init_cache(self.cfg, self.device)
        self.clients = init_clients(self.cfg, n_clients, seed, self.device)
        self.stats = init_stats(self.device)
        self.free = list(range(n_pages))          # physical page indices
        self.page_of_key: dict = {}               # host mirror for reclaim
        self.lookups = 0
        self.hits = 0

    def _reclaim(self):
        """Reconcile host free-list with device-side evictions."""
        size = self.state.size
        live_keys = set(self.state.key[(size != 0) & (size != 0xFF)]
                        .cpu().tolist())
        dead = [k for k in self.page_of_key if k not in live_keys]
        for k in dead:
            self.free.append(self.page_of_key.pop(k))

    def lookup_or_allocate(self, prompt_tokens: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, int]:
        """For one prompt: returns (page_keys, physical_pages, n_cached_prefix).

        Pages [0..n_cached_prefix) can skip prefill (prefix cache hits);
        the rest were newly allocated."""
        keys = prefix_page_keys(prompt_tokens, self.page_size)
        pages = np.zeros(len(keys), np.int64)
        n_hit = 0
        still_prefix = True
        width = self.clients.fc_slot.shape[0]
        for i, k in enumerate(keys):
            if len(self.free) == 0:
                self._reclaim()
            phys = self.page_of_key.get(int(k))
            hit = phys is not None
            if hit and still_prefix:
                n_hit += 1
            if not hit:
                still_prefix = False
                phys = self.free.pop() if self.free else 0
                self.page_of_key[int(k)] = phys
            pages[i] = phys
            kb = torch.zeros((width,), dtype=torch.int64)
            kb[0] = int(k)
            vb = torch.zeros((width, 1), dtype=torch.int64)
            vb[0, 0] = phys
            self.state, self.clients, self.stats, res = access(
                self.cfg, self.state, self.clients, self.stats,
                kb.to(self.device), values=vb.to(self.device),
                insert_on_miss=True)
            self.lookups += 1
            self.hits += int(bool(res.hit[0])) if hit else 0
        return keys, pages, n_hit

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    @property
    def weights(self) -> np.ndarray:
        """Eviction-driving weights: the client-local (regret-updated) ones
        (global weights only refresh on lazy sync, §4.3.2)."""
        w = self.clients.local_weights[0].cpu().numpy()
        return w / max(w.sum(), 1e-9)

    @property
    def regrets(self) -> int:
        return int(self.stats.regrets)
