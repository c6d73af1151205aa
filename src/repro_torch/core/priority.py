"""Caching algorithms as priority functions (paper §4.2, Table 3).

A caching algorithm reduces to ``priority(md) -> f32`` (the sampled
object with the lowest priority is the victim) plus an optional
extension-metadata update on every access.  Elementwise torch mirrors
of ``repro/core/priority.py``; f32 throughout, with the same order of
conversion and arithmetic so results round as the reference's do.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.core.types import MDView

EXT_LRUK_TS0 = 0
EXT_LRUK_TS1 = 1
EXT_LRFU_CRF = 2
EXT_LIRS_IRR = 3

LRUK_K = 2
LRFU_LAMBDA = 0.05

_F32_TINY = float(torch.finfo(torch.float32).tiny)
_LN2_F32 = float(torch.tensor(0.6931471805599453, dtype=torch.float32))


def exp2(x: torch.Tensor) -> torch.Tensor:
    """2^x as XLA lowers ``jnp.exp2``: exp(f32(ln 2) * x).  A direct
    exp2 is more exact but differs from the reference by tens of ulp at
    long decay gaps."""
    return torch.exp(_LN2_F32 * x)


def p_lru(md: MDView) -> torch.Tensor:
    return md.last_ts


def p_mru(md: MDView) -> torch.Tensor:
    return -md.last_ts


def p_lfu(md: MDView) -> torch.Tensor:
    return md.freq


def p_fifo(md: MDView) -> torch.Tensor:
    return md.insert_ts


def p_size(md: MDView) -> torch.Tensor:
    return -md.size


def p_gds(md: MDView) -> torch.Tensor:
    return md.gds_L + md.cost / torch.clamp(md.size, min=1.0)


def p_gdsf(md: MDView) -> torch.Tensor:
    return md.gds_L + md.freq * md.cost / torch.clamp(md.size, min=1.0)


def p_lfuda(md: MDView) -> torch.Tensor:
    return md.gds_L + md.freq


def p_lruk(md: MDView) -> torch.Tensor:
    kth = torch.minimum(md.ext[..., EXT_LRUK_TS0], md.ext[..., EXT_LRUK_TS1])
    return torch.where(md.freq < LRUK_K, md.insert_ts, kth)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 subnormals to zero.  XLA flushes them on the CPU and the
    TPU has none, so a long-idle object's decayed CRF is exactly 0 there;
    PyTorch keeps subnormals, which would rank such objects apart."""
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def p_lrfu(md: MDView) -> torch.Tensor:
    crf = md.ext[..., EXT_LRFU_CRF]
    decay = _ftz(exp2(-LRFU_LAMBDA * (md.clock - md.last_ts)))
    return _ftz(crf * decay)


def p_lirs(md: MDView) -> torch.Tensor:
    irr = md.ext[..., EXT_LIRS_IRR]
    return -torch.maximum(irr, md.clock - md.last_ts)


def p_hyperbolic(md: MDView) -> torch.Tensor:
    return md.freq / torch.clamp(md.clock - md.insert_ts, min=1.0)


class Expert(NamedTuple):
    name: str
    priority: Callable[[MDView], torch.Tensor]
    gds_family: bool  # participates in the GreedyDual L-inflation update


REGISTRY: Dict[str, Expert] = {
    "lru": Expert("lru", p_lru, False),
    "mru": Expert("mru", p_mru, False),
    "lfu": Expert("lfu", p_lfu, False),
    "fifo": Expert("fifo", p_fifo, False),
    "size": Expert("size", p_size, False),
    "gds": Expert("gds", p_gds, True),
    "gdsf": Expert("gdsf", p_gdsf, True),
    "lfuda": Expert("lfuda", p_lfuda, True),
    "lruk": Expert("lruk", p_lruk, False),
    "lrfu": Expert("lrfu", p_lrfu, False),
    "lirs": Expert("lirs", p_lirs, False),
    "hyperbolic": Expert("hyperbolic", p_hyperbolic, False),
}

ALL_ALGORITHMS = tuple(REGISTRY)


def priorities(md: MDView, names) -> torch.Tensor:
    """Stacked priorities for all experts: shape [..., E]."""
    shape = torch.broadcast_shapes(md.size.shape, md.clock.shape)
    return torch.stack([REGISTRY[n].priority(md).expand(shape)
                        for n in names], dim=-1)


def update_ext(ext_row: torch.Tensor, old_last_ts: torch.Tensor,
               old_freq: torch.Tensor, clock: torch.Tensor) -> torch.Tensor:
    """Extension-metadata update on an access; ext_row [..., EXT_WIDTH],
    the integer arguments u32 (as int64)."""
    clock = clock.to(torch.float32)
    old_last = old_last_ts.to(torch.float32)
    new_freq = old_freq.to(torch.float32) + 1.0
    idx = torch.remainder(new_freq, float(LRUK_K))
    ts0 = torch.where(idx == 0.0, clock, ext_row[..., EXT_LRUK_TS0])
    ts1 = torch.where(idx == 1.0, clock, ext_row[..., EXT_LRUK_TS1])
    gap = clock - old_last
    crf = 1.0 + ext_row[..., EXT_LRFU_CRF] * exp2(-LRFU_LAMBDA * gap)
    return torch.stack([ts0, ts1, crf, gap], dim=-1)


def fresh_ext(clock: torch.Tensor, shape=()) -> torch.Tensor:
    """Extension metadata for a newly inserted object."""
    clock = clock.to(torch.float32).expand(shape)
    zero = torch.zeros_like(clock)
    return torch.stack([clock, zero, zero + 1.0, zero + 2.0**30], dim=-1)


def loc_of(name: str) -> int:
    """Lines of code of a policy's priority function (Table 3 analogue)."""
    src = inspect.getsource(REGISTRY[name].priority)
    lines = [l for l in src.splitlines()
             if l.strip() and not l.strip().startswith("#")]
    return len(lines)
