"""Launchers of the sampled-eviction CUDA kernels, one warp per op:
``ranked_eviction`` (``csrc/ranked_eviction.cu``), the quota-ranked
decision of ``core.access``, and ``sampled_eviction``
(``csrc/sampled_eviction.cu``), the single-victim decision at one
clock.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are ``kernels/ref.py::
ranked_eviction_ref`` and ``sampled_eviction_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime

# Kernel-supported experts: pure arithmetic over the default metadata.
# The position in this tuple is the expert's code in the kernel.
KERNEL_EXPERTS = ("lru", "lfu", "fifo", "size", "hyperbolic")
# A sample of up to this many slots is compacted onto the lanes of one
# warp; a wider one goes through a per-op scratch row.
LANES = 32

_CODES: dict = {}


def expert_codes(experts, dev) -> torch.Tensor:
    """Device array of expert codes, made once per (experts, device)."""
    key = (tuple(experts), str(dev))
    if key not in _CODES:
        _CODES[key] = torch.tensor([KERNEL_EXPERTS.index(e) for e in experts],
                                   dtype=torch.int32, device=dev)
    return _CODES[key]


def ranked_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                    must_evict, quota, ts, *, window: int, k: int, experts,
                    tenant=None, tfilt=None):
    """Returns victims i64[B, k] (-1 where not taken), cand i64[B, E]."""
    B = offsets.shape[0]
    E = len(experts)
    dev = offsets.device
    victims = torch.empty((B, k), dtype=torch.int64, device=dev)
    cand = torch.empty((B, E), dtype=torch.int64, device=dev)
    # A sample wider than a warp: positions and five f32 fields an entry.
    wide = k > LANES
    wpos = torch.empty((B, k), dtype=torch.int32, device=dev) if wide else None
    wmd = (torch.empty((B, 5, k), dtype=torch.float32, device=dev) if wide
           else None)
    filt = tenant is not None and tfilt is not None
    err = runtime.lib().ranked_eviction_launch(
        size.data_ptr(), insert_ts.data_ptr(), last_ts.data_ptr(),
        freq.data_ptr(), tenant.data_ptr() if filt else None, size.shape[0],
        offsets.data_ptr(), e_choice.data_ptr(), must_evict.data_ptr(),
        quota.data_ptr(), 1 if quota.dim() else 0,
        tfilt.data_ptr() if filt else None, ts.data_ptr(),
        expert_codes(experts, dev).data_ptr(), B, window, k, E,
        victims.data_ptr(), cand.data_ptr(),
        wpos.data_ptr() if wide else None, wmd.data_ptr() if wide else None,
        runtime.counter("ranked_eviction", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "ranked_eviction")
    return victims, cand


def sampled_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                     clock, *, window: int, k: int, experts):
    """Returns victim i64[B], cand i64[B, E].  ``clock`` is a 0-d f32
    tensor on the card or a float."""
    B = offsets.shape[0]
    E = len(experts)
    dev = offsets.device
    victim = torch.empty(B, dtype=torch.int64, device=dev)
    cand = torch.empty((B, E), dtype=torch.int64, device=dev)
    wide = k > LANES    # a sample wider than a warp: its positions
    wpos = torch.empty((B, k), dtype=torch.int32, device=dev) if wide else None
    on_card = isinstance(clock, torch.Tensor)
    err = runtime.lib().sampled_eviction_launch(
        size.data_ptr(), insert_ts.data_ptr(), last_ts.data_ptr(),
        freq.data_ptr(), size.shape[0], offsets.data_ptr(),
        e_choice.data_ptr(), clock.data_ptr() if on_card else None,
        0.0 if on_card else clock, expert_codes(experts, dev).data_ptr(), B,
        window, k, E, victim.data_ptr(), cand.data_ptr(),
        wpos.data_ptr() if wide else None,
        runtime.counter("sampled_eviction", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "sampled_eviction")
    return victim, cand
