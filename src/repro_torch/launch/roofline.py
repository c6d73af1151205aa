"""Roofline terms of one step on an NVIDIA H100, from the op counter of
``launch/op_cost.py``: the port's ``repro/launch/roofline.py``, with the
card's constants in place of the TPU's.

The constants are spec-sheet figures, not measurements: NVIDIA H100 80GB
HBM3 (SXM), at its 700 W power limit (a card set lower runs slower
under load; ``nvidia-smi --query-gpu=name,power.limit`` says which):

  * ``PEAK_FLOPS``: 989 TFLOP/s, dense bf16 on the tensor cores;
  * ``HBM_BW``: 3.35 TB/s of HBM3;
  * ``NVLINK_BW``: 450 GB/s a direction (NVLink 4, 18 links of 25 GB/s)
    between the 8 cards of a node, all to all through NVSwitch;
  * ``NET_BW``: 50 GB/s a card off its node: one 400 Gb/s InfiniBand
    NDR port for each card, the usual DGX/HGX H100 build.  A collective
    whose group spans more than ``NODE`` cards is charged at this rate,
    since its ring crosses the node's network, however much of it runs
    over NVLink.

A step's collective term is each kind's bytes over the rate of the
slowest link its group crosses: the mesh axes of the step's collectives
are not recorded per op, so :func:`analyze` charges every collective at
the rate of the largest group the mesh has (``group``, the product of
the axes a collective may span).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12      # bf16 dense, per card (spec sheet)
HBM_BW = 3.35e12         # bytes/s per card (spec sheet)
NVLINK_BW = 450e9        # bytes/s per card and direction in a node
NET_BW = 50e9            # bytes/s per card off its node (400 Gb/s)
NODE = 8                 # cards a node, all to all over NVLink
CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"


def link_bw(group: int) -> float:
    """The rate a collective over ``group`` cards gets: NVLink within a
    node, the network beyond one."""
    return NVLINK_BW if group <= NODE else NET_BW


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    n_devices: int
    model_flops: float = 0.0   # 6*N*D or 2*N_active*D, whole-model
    fused_bytes_per_device: float = 0.0  # perfectly-fused traffic estimate
    group: int = 1             # the cards a collective spans (link_bw)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        """Pessimistic: op-granularity traffic (every op's operands and
        results)."""
        return self.bytes_per_device / HBM_BW

    @property
    def t_memory_fused(self) -> float:
        """Optimistic: product I/O (bf16) + gathers/scatters + collective
        traffic: what a well-fused step must still move through HBM."""
        return self.fused_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / link_bw(self.group)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory_fused,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step-time bound (max of terms; fused memory model)."""
        return max(self.t_compute, self.t_memory_fused, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs across all cards): remat and
        redundancy."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline MFU: model FLOPs / (cards * peak * step_time)."""
        denom = self.n_devices * PEAK_FLOPS * self.step_time
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_device,
            "bytes_per_dev": self.bytes_per_device,
            "fused_bytes_per_dev": self.fused_bytes_per_device,
            "coll_bytes_per_dev": self.coll_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_fused_s": self.t_memory_fused,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }


def analyze(report, n_devices: int, model_flops: float = 0.0,
            group: int | None = None) -> Roofline:
    """A :class:`Roofline` from an ``op_cost.CostReport`` of one step;
    ``group`` (default: all ``n_devices``) sets the collectives' link."""
    coll = dict(report.coll_breakdown)
    coll["_counts"] = report.coll_counts  # type: ignore
    return Roofline(report.flops, report.bytes, report.coll_bytes, coll,
                    n_devices, model_flops, report.fused_bytes,
                    n_devices if group is None else group)
