"""Fault-tolerant training loop: checkpoint/restart, preemption handling,
straggler detection, as in ``repro/train/loop.py``.

The loop assumes any step can die (checkpoints are atomic and
resumable), watches per-step wall times for stragglers (a slow step
triggers the rebalance hook), and drains cleanly on SIGTERM (one final
checkpoint).  A step's wall time is taken on the host around the step
and the loss's ``float()``, which waits for the device.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerPolicy:
    """Slow-step detector: a step slower than `factor` x the running median
    triggers mitigation (data-shard rebalance / backup execution)."""

    factor: float = 3.0
    window: int = 50
    min_samples: int = 8

    def __post_init__(self):
        self.times: list = []
        self.triggers = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) < self.min_samples:
            return False
        med = float(np.median(self.times[:-1]))
        if dt > self.factor * med:
            self.triggers += 1
            return True
        return False


class TrainLoop:
    def __init__(self, step_fn: Callable, ckpt_dir: str, *,
                 ckpt_every: int = 50, keep: int = 3,
                 straggler: Optional[StragglerPolicy] = None,
                 on_straggler: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.straggler = straggler or StragglerPolicy()
        self.on_straggler = on_straggler
        self._stop = False
        self.losses: list = []

    def _handle_sigterm(self, *_):
        self._stop = True  # drain: finish the step, checkpoint, exit

    def run(self, params, opt, batches, n_steps: int, start_step: int = 0,
            resume: bool = True, log_every: int = 10,
            log=print):
        if resume and self.mgr.latest_step() is not None:
            s = self.mgr.latest_step()
            restored = self.mgr.restore(s, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            start_step = s
            log(f"[loop] resumed from checkpoint step {s}")
        old = signal.signal(signal.SIGTERM, self._handle_sigterm)
        try:
            for i in range(start_step, n_steps):
                t0 = time.time()
                params, opt, loss = self.step_fn(params, opt, batches(i))
                loss = float(loss)      # waits for the device
                dt = time.time() - t0
                self.losses.append(loss)
                if self.straggler.observe(dt) and self.on_straggler:
                    self.on_straggler(i)
                if (i + 1) % log_every == 0:
                    log(f"[loop] step {i+1} loss {loss:.4f} "
                        f"({dt*1e3:.0f} ms)")
                if (i + 1) % self.ckpt_every == 0 or self._stop:
                    self.mgr.save(i + 1, {"params": params, "opt": opt})
                if self._stop:
                    log(f"[loop] SIGTERM: drained at step {i+1}")
                    break
        finally:
            signal.signal(signal.SIGTERM, old)
            self.mgr.wait()
        return params, opt
