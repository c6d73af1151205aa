"""Baselines (a torch port of ``repro.baselines``): the exact-policy
oracles and ``PyDitto`` (host Python), and the comparison systems' cost
models (host numpy)."""

from repro_torch.baselines.policies import PyDitto, simulate_policy
from repro_torch.baselines.systems import (CLUSTER, CliqueMapModel,
                                           DittoModel, RedisModel,
                                           ShardLRUModel)

__all__ = ["simulate_policy", "PyDitto", "CLUSTER", "CliqueMapModel",
           "DittoModel", "RedisModel", "ShardLRUModel"]
