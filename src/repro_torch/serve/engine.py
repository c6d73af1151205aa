"""Continuous-batching decode engine with the Ditto-managed prefix
cache, as in ``repro/serve/engine.py``.

A fixed pool of decode lanes; requests join as lanes free up
(continuous batching) instead of waiting for a full batch to drain.
Each admitted prompt is looked up in the Ditto page cache, which
records how many page-aligned prefix pages it already holds; the prompt
is then teacher-forced through the decode step, cached pages included,
as in the JAX package (the KV tensor is lane-local, so a prefill that
skips cached pages needs a paged KV variant).

The step runs eagerly on the device of the params: one decode step a
call to ``serve/decode.py``'s ``make_serve_step``.  The page cache lives
on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import ModelConfig
from repro_torch.serve.decode import init_cache, make_serve_step, reset_lane
from repro_torch.serve.page_cache import DittoPageCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # uint32 tokens
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    prefill_pos: int = 0          # next prompt token to feed
    done: bool = False
    pages_skipped: int = 0


class DecodeEngine:
    """Batched lanes + continuous admission + prefix-cache accounting."""

    def __init__(self, cfg: ModelConfig, params, *, lanes: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 pool_pages: int = 256):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.lanes = lanes
        self.max_len = max_len
        self.step = make_serve_step(cfg)
        self.pagecache = DittoPageCache(pool_pages, page_size,
                                        device=self.device)
        self.page_size = page_size
        # one shared KV cache tensor; per-lane logical sequences
        self.cache = init_cache(cfg, lanes, max_len, self.device)
        self.active: List[Optional[Request]] = [None] * lanes
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, rid: int):
        self.queue.append(Request(rid, prompt.astype(np.uint32), max_new))

    def _admit(self):
        for i in range(self.lanes):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                _, _, n_hit = self.pagecache.lookup_or_allocate(req.prompt)
                # cached prefix pages are counted; the engine still
                # replays them through the decode step (see the module
                # docstring).
                req.pages_skipped = n_hit
                self.cache = reset_lane(self.cfg, self.cache, i)
                self.active[i] = req

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10_000):
        """Drive all lanes until queue + lanes drain."""
        while (any(self.active) or self.queue) and self.steps < max_steps:
            self._admit()
            if not any(self.active):
                break
            toks = np.zeros((self.lanes, 1), np.int64)
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                if req.prefill_pos < len(req.prompt):
                    toks[i, 0] = int(req.prompt[req.prefill_pos])
                elif req.out:
                    toks[i, 0] = int(req.out[-1])
            nxt, self.cache = self.step(
                self.params, self.cache,
                tokens=torch.from_numpy(toks).to(self.device))
            nxt = nxt.cpu().numpy()
            self.steps += 1
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                if req.prefill_pos < len(req.prompt):
                    req.prefill_pos += 1
                    if req.prefill_pos == len(req.prompt):
                        req.out.append(int(nxt[i]))
                else:
                    req.out.append(int(nxt[i]))
                if (len(req.out) >= req.max_new
                        or req.prefill_pos + len(req.out) >= self.max_len - 1):
                    req.done = True
                    self.finished.append(req)
                    self.active[i] = None
        return self.finished

    @property
    def prefix_hit_rate(self) -> float:
        return self.pagecache.hit_rate
