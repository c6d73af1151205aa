"""The training path on PyTorch (a port of ``repro.train``): AdamW with
microbatched accumulation, checkpoints in the JAX package's format,
int8 gradient compression and the fault-tolerant loop.  The JAX
package's ``zero_specs`` (ZeRO-1 sharding specs) has no counterpart on
one card."""

from repro_torch.train.optimizer import (AdamWConfig, OptState, init_opt,
                                         make_train_step)
from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["AdamWConfig", "OptState", "init_opt", "make_train_step",
           "CheckpointManager"]
