"""Training launcher, as ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --scale smoke --ckpt ckpt_dir [--resume]

--scale smoke uses the reduced per-arch config; --scale full the
published config.  Runs on the card unless ``--device cpu``.  Weights
are random, drawn from a ``torch.Generator`` seeded with ``--seed``;
the data is ``synthetic_batches``, the JAX package's tokens for a seed.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, init_opt, make_train_step
from repro_torch.train.loop import StragglerPolicy, TrainLoop


def synthetic_batches(cfg, batch, seq, seed=0, device=None):
    """Deterministic synthetic LM data (a zipfian token stream): batch
    ``i`` holds the JAX package's tokens for ``seed + i``, as int64
    tensors on ``device`` (default: the card)."""
    device = torch.device("cuda" if device is None else device)
    ranks = np.arange(1, cfg.vocab_size)
    p = ranks ** -1.1
    p /= p.sum()

    def get(i):
        r = np.random.default_rng(seed + i)
        toks = torch.from_numpy(r.choice(len(p), size=(batch, seq + 1),
                                         p=p) + 1).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return get


def adamw_config(lr: float, steps: int) -> AdamWConfig:
    """The launcher's optimizer settings: 20 warmup steps, cosine decay
    over the run."""
    return AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cfg = get_arch(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    opt = init_opt(params)
    step = make_train_step(cfg, adamw_config(args.lr, args.steps),
                           n_microbatches=args.microbatches, remat="none")
    loop = TrainLoop(step, args.ckpt, ckpt_every=args.ckpt_every,
                     straggler=StragglerPolicy(),
                     on_straggler=lambda i: print(f"[straggler] step {i}: "
                                                  "rebalance triggered"))
    batches = synthetic_batches(cfg, args.batch, args.seq, device=dev)
    loop.run(params, opt, batches, args.steps, resume=args.resume)
    print(f"final loss {loop.losses[-1]:.4f} (first {loop.losses[0]:.4f}) "
          f"straggler_triggers={loop.straggler.triggers}")
    return loop


if __name__ == "__main__":
    main()
