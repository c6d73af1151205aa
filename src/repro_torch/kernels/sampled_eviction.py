"""Launchers of the sampled-eviction CUDA kernels, one warp per op:
``ranked_eviction`` (``csrc/ranked_eviction.cu``), the quota-ranked
decision of ``core.access``, given each op's offset and expert choice or
drawing them itself (``ranked_eviction_draw``, the cache step's form),
and ``sampled_eviction`` (``csrc/sampled_eviction.cu``), the
single-victim decision at one clock.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are ``kernels/ref.py::
ranked_eviction_ref``, ``ranked_eviction_draw_ref`` and
``sampled_eviction_ref``.
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
# The eviction kernels take the expert codes by value, four bits each in
# one 64-bit argument.
MAX_EXPERTS = 8

_CODES: dict = {}


def expert_codes(experts, dev) -> torch.Tensor:
    """Device array of expert codes, made once per (experts, device)."""
    key = (tuple(experts), str(dev))
    if key not in _CODES:
        _CODES[key] = torch.tensor([KERNEL_EXPERTS.index(e) for e in experts],
                                   dtype=torch.int32, device=dev)
    return _CODES[key]


def packed_codes(experts) -> int:
    """The experts' codes, expert e's in bits [4e, 4e + 4)."""
    return sum(KERNEL_EXPERTS.index(x) << (4 * e)
               for e, x in enumerate(experts))


def _scratch(B: int, k: int, fields: int, dev) -> tuple:
    """A sample wider than a warp: positions and ``fields`` f32 words an
    entry, per op; (None, None) otherwise."""
    if k <= LANES:
        return None, None
    return (torch.empty((B, k), dtype=torch.int32, device=dev),
            torch.empty((B, fields, k), dtype=torch.float32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def ranked_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                    must_evict, quota, ts, *, window: int, k: int, experts,
                    tenant=None, tfilt=None):
    """Returns victims i64[B, k] (-1 where not taken), cand i64[B, E]."""
    B = offsets.shape[0]
    E = len(experts)
    dev = offsets.device
    victims = torch.empty((B, k), dtype=torch.int64, device=dev)
    cand = torch.empty((B, E), dtype=torch.int64, device=dev)
    wpos, wmd = _scratch(B, k, 5, dev)
    filt = tenant is not None and tfilt is not None
    err = runtime.lib().ranked_eviction_launch(
        size.data_ptr(), insert_ts.data_ptr(), last_ts.data_ptr(),
        freq.data_ptr(), tenant.data_ptr() if filt else None, size.shape[0],
        offsets.data_ptr(), e_choice.data_ptr(), must_evict.data_ptr(),
        quota.data_ptr(), 1 if quota.dim() else 0,
        tfilt.data_ptr() if filt else None, ts.data_ptr(),
        packed_codes(experts), B, window, k, E, victims.data_ptr(),
        cand.data_ptr(), _ptr(wpos), _ptr(wmd),
        runtime.counter("ranked_eviction", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "ranked_eviction")
    return victims, cand


def ranked_eviction_draw(size, insert_ts, last_ts, freq, rng, cdf,
                         must_evict, quota, ts, *, window: int, k: int,
                         experts, tenant=None, tfilt=None, op_tenant=None):
    """Returns victims i64[B, k], cand i64[B, E], e_choice i64[B] and the
    victims' expert bitmaps i64[B, k]; counted as ``ranked_eviction``.
    ``op_tenant`` i64[B] picks each op's row of a [lanes, T, E] cdf."""
    B = ts.shape[0]
    E = len(experts)
    dev = ts.device
    victims = torch.empty((B, k), dtype=torch.int64, device=dev)
    bmap = torch.empty((B, k), dtype=torch.int64, device=dev)
    cand = torch.empty((B, E), dtype=torch.int64, device=dev)
    e_choice = torch.empty(B, dtype=torch.int64, device=dev)
    wpos, wmd = _scratch(B, k, 5, dev)
    filt = tenant is not None and tfilt is not None
    err = runtime.lib().ranked_eviction_draw_launch(
        size.data_ptr(), insert_ts.data_ptr(), last_ts.data_ptr(),
        freq.data_ptr(), tenant.data_ptr() if filt else None, size.shape[0],
        rng.data_ptr(), rng.shape[0], cdf.data_ptr(), _ptr(op_tenant),
        cdf.shape[1] if op_tenant is not None else 1, must_evict.data_ptr(),
        quota.data_ptr(), 1 if quota.dim() else 0,
        tfilt.data_ptr() if filt else None, ts.data_ptr(),
        packed_codes(experts), B, window, k, E, victims.data_ptr(),
        cand.data_ptr(), e_choice.data_ptr(), bmap.data_ptr(), _ptr(wpos),
        _ptr(wmd), runtime.counter("ranked_eviction", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "ranked_eviction")
    return victims, cand, e_choice, bmap


def sampled_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                     clock, *, window: int, k: int, experts):
    """Returns victim i64[B], cand i64[B, E].  ``clock`` is a 0-d f32
    tensor on the card or a float."""
    B = offsets.shape[0]
    E = len(experts)
    dev = offsets.device
    victim = torch.empty(B, dtype=torch.int64, device=dev)
    cand = torch.empty((B, E), dtype=torch.int64, device=dev)
    wpos, wmd = _scratch(B, k, 4, dev)
    on_card = isinstance(clock, torch.Tensor)
    err = runtime.lib().sampled_eviction_launch(
        size.data_ptr(), insert_ts.data_ptr(), last_ts.data_ptr(),
        freq.data_ptr(), size.shape[0], offsets.data_ptr(),
        e_choice.data_ptr(), clock.data_ptr() if on_card else None,
        0.0 if on_card else clock, packed_codes(experts), B, window, k, E,
        victim.data_ptr(), cand.data_ptr(), _ptr(wpos), _ptr(wmd),
        runtime.counter("sampled_eviction", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "sampled_eviction")
    return victim, cand
