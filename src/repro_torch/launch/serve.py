"""Serving entry point: batched decode with the Ditto-managed prefix/page
cache, as ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 24 --prompt-len 96 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --scale full --arch yi-9b

Runs on the card unless ``--device cpu``.  Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed``.  Numbers printed from
a card run carry the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels.runtime import device_line
from repro_torch.models import init_params
from repro_torch.serve import DittoPageCache, init_cache, make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=96)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cfg = get_arch(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    step = make_serve_step(cfg)
    pagecache = DittoPageCache(args.pool_pages, args.page_size, device=dev)

    # Request stream with shared prefixes (few-shot/system-prompt shape).
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(1, cfg.vocab_size, args.prompt_len // 2
                          ).astype(np.uint32)
    t0 = time.perf_counter()
    total_new = 0
    skipped_pages = 0
    for r in range(0, args.requests, args.batch):
        prompts = []
        for b in range(args.batch):
            tail = rng.integers(1, cfg.vocab_size, args.prompt_len
                                - len(shared)).astype(np.uint32)
            p = np.concatenate([shared, tail])
            _, _, n_hit = pagecache.lookup_or_allocate(p)
            skipped_pages += n_hit
            prompts.append(p)
        toks = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
        cache = init_cache(cfg, args.batch, args.prompt_len + args.gen + 1,
                           dev)
        # prefill via teacher-forced decode (cached pages would skip this)
        nxt = None
        for i in range(args.prompt_len):
            nxt, cache = step(params, cache, tokens=toks[:, i:i + 1])
        out = [nxt]
        for _ in range(args.gen):
            nxt, cache = step(params, cache, tokens=out[-1][:, None].long())
            out.append(nxt)
            total_new += args.batch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[{device_line(dev)}] {cfg.name}: served {args.requests} "
          f"requests: {total_new} new tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s)")
    print(f"prefix cache: hit_rate={pagecache.hit_rate:.2f} "
          f"pages_skipped={skipped_pages} "
          f"weights={np.round(pagecache.weights, 3)} "
          f"evictions={int(pagecache.stats.evictions)}")


if __name__ == "__main__":
    main()
