"""Comparison-system cost models (a torch port of part of
``repro.baselines``): the Ditto throughput model the elastic scenario
driver reports."""

from repro_torch.baselines.systems import CLUSTER, DittoModel

__all__ = ["CLUSTER", "DittoModel"]
