"""The training path on PyTorch (a port of ``repro.train``): AdamW with
microbatched accumulation, checkpoints in the JAX package's format,
int8 gradient compression and the fault-tolerant loop; under a mesh
``zero_specs`` gives the ZeRO-1 sharding specs of the optimizer's
trees."""

from repro_torch.train.optimizer import (AdamWConfig, OptState, init_opt,
                                         make_train_step, zero_specs)
from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["AdamWConfig", "OptState", "init_opt", "make_train_step",
           "zero_specs", "CheckpointManager"]
