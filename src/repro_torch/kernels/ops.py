"""The op wrappers of the hand-written kernels: the four cache kernels
of ``core.access`` (the probe, the in-place hit-metadata update, the
ranked eviction and the apply's ``drop_scatter``), the flash-attention
kernel of the LM prefill, and the three cache kernels that only this
entry point reaches (``sampled_eviction_op``, ``bucket_lookup_op``,
``metadata_update_op``, the JAX package's ``repro.kernels.ops`` forms).
A trailing underscore marks an op that updates its arguments in place.

Each wrapper checks its arguments (dtype, device, shape, contiguity) and
dispatches on the device of the tensors it is given: CPU tensors go to
the plain version in ``kernels/ref.py``; CUDA tensors go to the
hand-written kernel, which is built at first use, and any failure to
build or launch raises.  Every kernel launch adds one to the kernel's
count on the device (``kernels/runtime.py``), also when the launch is
replayed from a CUDA graph (``core/cache.py::_scan``); :func:`launches`
reads the counts, so a run can show that its main path went through the
kernels.  The plain versions count nothing.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bucket_lookup import access_probe, bucket_lookup
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.metadata_update import (hit_metadata_update_,
                                                 metadata_update)
from repro_torch.kernels.runtime import launch_counts as launches
from repro_torch.kernels.runtime import reset_counts as reset_launches
from repro_torch.kernels.sampled_eviction import (KERNEL_EXPERTS, MAX_SAMPLES,
                                                  ranked_eviction,
                                                  sampled_eviction)
from repro_torch.kernels.scatter import MAX_COLS, drop_scatter

__all__ = ["access_probe_op", "hit_metadata_update_op",
           "hit_metadata_update_op_", "ranked_eviction_op", "drop_scatter_op_",
           "flash_attention_op", "sampled_eviction_op", "bucket_lookup_op",
           "metadata_update_op", "KERNEL_EXPERTS", "launches",
           "reset_launches"]

I64, F32, BOOL = torch.int64, torch.float32, torch.bool


def _check(op: str, device, **tensors) -> None:
    """tensors: name -> (tensor, dtype, shape); a None dim matches any."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if len(shape) != t.dim() or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def _clock(op: str, clock, device):
    """A scalar clock: a 0-d f32 tensor on ``device`` as it is, a number
    rounded to f32 (as ``jnp.asarray(clock, jnp.float32)`` rounds it)."""
    if isinstance(clock, torch.Tensor):
        _check(op, device, clock=(clock, F32, ()))
        return clock
    if not isinstance(clock, numbers.Real):
        raise TypeError(f"{op}: clock must be a number or a 0-d tensor, got "
                        f"{type(clock).__name__}")
    return float(np.float32(clock))


def _experts(op: str, experts) -> tuple:
    experts = tuple(experts)
    bad = [e for e in experts if e not in KERNEL_EXPERTS]
    if bad:
        raise ValueError(f"{op} supports {KERNEL_EXPERTS}; got {bad}")
    return experts


def _dispatch(op: str, device, kernel, plain, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if device.type == "cuda":
        return kernel(*args, **kw)
    if device.type == "cpu":
        return plain(*args, **kw)
    raise ValueError(f"{op}: no kernel for device {device}")


def access_probe_op(table_key, table_size, table_hash, table_ptr, keys,
                    hist_ctr, *, assoc: int, history_len: int):
    """Bucket match + embedded-history match for u32 keys [B]."""
    dev = keys.device
    n = table_key.shape[0]
    B = keys.shape[0]
    if n % assoc:
        raise ValueError(f"access_probe: {n} slots is not a multiple of "
                         f"assoc={assoc}")
    _check("access_probe", dev, table_key=(table_key, I64, (n,)),
           table_size=(table_size, I64, (n,)),
           table_hash=(table_hash, I64, (n,)),
           table_ptr=(table_ptr, I64, (n,)), keys=(keys, I64, (B,)),
           hist_ctr=(hist_ctr, I64, ()))
    args = (table_key, table_size, table_hash, table_ptr, keys, hist_ctr)
    return _dispatch("access_probe", dev, access_probe, ref.access_probe_ref,
                     *args, assoc=assoc, history_len=history_len)


def hit_metadata_update_op_(freq, last_ts, ext, hit_slots, hit_ts,
                            emit_slots, emit_deltas) -> None:
    """Hit-slot last_ts/ext update and FC-flush freq FAA, in place in
    (freq, last_ts, ext); the ext update reads their step-entry values."""
    dev = freq.device
    n, bh, be = freq.shape[0], hit_slots.shape[0], emit_slots.shape[0]
    _check("hit_metadata_update", dev, freq=(freq, I64, (n,)),
           last_ts=(last_ts, I64, (n,)), ext=(ext, F32, (n, 4)),
           hit_slots=(hit_slots, I64, (bh,)), hit_ts=(hit_ts, I64, (bh,)),
           emit_slots=(emit_slots, I64, (be,)),
           emit_deltas=(emit_deltas, I64, (be,)))
    args = (freq, last_ts, ext, hit_slots, hit_ts, emit_slots, emit_deltas)
    _dispatch("hit_metadata_update", dev, hit_metadata_update_,
              ref.hit_metadata_update_ref_, *args)


def hit_metadata_update_op(freq, last_ts, ext, hit_slots, hit_ts, emit_slots,
                           emit_deltas):
    """:func:`hit_metadata_update_op_` into fresh (freq, last_ts, ext)
    tensors, as the JAX op returns them; the inputs stay as they are."""
    out = (freq.clone(), last_ts.clone(), ext.clone())
    hit_metadata_update_op_(*out, hit_slots, hit_ts, emit_slots, emit_deltas)
    return out


def drop_scatter_op_(idx, cols, srcs) -> None:
    """In place, for each column of ``cols`` (all of one length n, [n] or
    [n, W], int64 or f32): ``col[idx[b]] = src[b]`` where
    ``0 <= idx[b] < n``, and nothing for any other index (``idx`` i64[B]).
    Each ``src`` is a [B] or [B, W] tensor of its column's dtype, or an
    integer written to every such row of an int64 column.  In-range
    indices must be unique, or their entries write equal rows."""
    dev = idx.device
    B = idx.shape[0]
    if not 0 < len(cols) == len(srcs) <= MAX_COLS:
        raise ValueError(f"drop_scatter: {len(cols)} columns and "
                         f"{len(srcs)} sources (1 to {MAX_COLS} of each)")
    n = cols[0].shape[0]
    spec = dict(idx=(idx, I64, (B,)))
    for k, (col, src) in enumerate(zip(cols, srcs)):
        if col.dtype not in (I64, F32) or col.dim() not in (1, 2):
            raise TypeError(f"drop_scatter: column {k} is {col.dtype} of "
                            f"{col.dim()} dims (int64 or f32, 1 or 2 dims)")
        row = tuple(col.shape[1:])
        spec[f"col{k}"] = (col, col.dtype, (n,) + row)
        if torch.is_tensor(src):
            spec[f"src{k}"] = (src, col.dtype, (B,) + row)
        elif not (isinstance(src, numbers.Integral) and col.dtype == I64):
            raise TypeError(f"drop_scatter: source {k} must be a tensor, or "
                            "an integer for an int64 column")
    _check("drop_scatter", dev, **spec)
    _dispatch("drop_scatter", dev, drop_scatter, ref.drop_scatter_ref, idx,
              tuple(cols), tuple(srcs))


def ranked_eviction_op(size, insert_ts, last_ts, freq, offsets, e_choice,
                       must_evict, quota, ts, *, window: int, k: int,
                       experts, tenant=None, tfilt=None):
    """Sampled, chosen-expert ranked eviction over the u32 table columns
    [C] (windows index them mod C).  ``quota`` is i64[B] or a scalar
    tensor; ``tenant`` [C] with ``tfilt`` i64[B] (-1 = unfiltered)
    scopes an op's sample to one tenant.  Returns victims i64[B, k] and
    per-expert candidates i64[B, E]."""
    dev = offsets.device
    n, B = size.shape[0], offsets.shape[0]
    experts = _experts("ranked_eviction", experts)
    if not 0 < window <= n:
        raise ValueError(f"ranked_eviction: window={window} for {n} slots")
    if not 0 < k <= min(window, MAX_SAMPLES):
        raise ValueError(f"ranked_eviction: k={k} must be in [1, "
                         f"min(window, {MAX_SAMPLES})]")
    cols = dict(size=(size, I64, (n,)), insert_ts=(insert_ts, I64, (n,)),
                last_ts=(last_ts, I64, (n,)), freq=(freq, I64, (n,)),
                offsets=(offsets, I64, (B,)), e_choice=(e_choice, I64, (B,)),
                must_evict=(must_evict, BOOL, (B,)),
                quota=(quota, I64, (B,) if quota.dim() else ()),
                ts=(ts, I64, (B,)))
    if (tenant is None) != (tfilt is None):
        raise ValueError("ranked_eviction: tenant and tfilt go together")
    if tenant is not None:
        cols.update(tenant=(tenant, I64, (n,)), tfilt=(tfilt, I64, (B,)))
    _check("ranked_eviction", dev, **cols)
    args = (size, insert_ts, last_ts, freq, offsets, e_choice, must_evict,
            quota, ts)
    return _dispatch("ranked_eviction", dev, ranked_eviction,
                     ref.ranked_eviction_ref, *args, window=window, k=k,
                     experts=experts, tenant=tenant, tfilt=tfilt)


def sampled_eviction_op(size, insert_ts, last_ts, freq, offsets, e_choice,
                        clock, *, window: int = 20, k: int = 5,
                        experts=("lru", "lfu")):
    """Single-victim sampled eviction at one scalar clock (a number or a
    0-d f32 tensor).  The columns are f32[C + window], padded at the tail
    with empty slots by the caller, so op b's window is the positions
    ``offsets[b] + j``, j < window, never taken mod C (a position outside
    the columns reads as an empty slot).  Returns victim i64[B] (-1 where
    the sample is empty or ``e_choice`` is outside [0, E)) and cand
    i64[B, E] (-1 where the sample is empty), as window positions.  Any
    B: the JAX op's ``block_b`` tiling, and its B % 8 == 0, are gone."""
    dev = offsets.device
    n, B = size.shape[0], offsets.shape[0]
    experts = _experts("sampled_eviction", experts)
    if not 0 < window <= n:
        raise ValueError(f"sampled_eviction: window={window} for {n} "
                         "padded slots")
    if not 0 < k <= MAX_SAMPLES:
        raise ValueError(f"sampled_eviction: k={k} must be in [1, "
                         f"{MAX_SAMPLES}]")
    _check("sampled_eviction", dev, size=(size, F32, (n,)),
           insert_ts=(insert_ts, F32, (n,)), last_ts=(last_ts, F32, (n,)),
           freq=(freq, F32, (n,)), offsets=(offsets, I64, (B,)),
           e_choice=(e_choice, I64, (B,)))
    args = (size, insert_ts, last_ts, freq, offsets, e_choice,
            _clock("sampled_eviction", clock, dev))
    return _dispatch("sampled_eviction", dev, sampled_eviction,
                     ref.sampled_eviction_ref, *args, window=window, k=k,
                     experts=experts)


def bucket_lookup_op(table_key, table_size, keys, *, assoc: int = 8):
    """Bucket match alone for u32 keys [B] over u32 key and size columns
    [C] (int64 tensors): returns (found bool[B], slot i64[B], -1 on a
    miss).  The table has floor(C / assoc) buckets.  Any B: the JAX op's
    ``block_b`` tiling is gone."""
    dev = keys.device
    n, B = table_key.shape[0], keys.shape[0]
    if not 0 < assoc <= n:
        raise ValueError(f"bucket_lookup: assoc={assoc} for {n} slots")
    _check("bucket_lookup", dev, table_key=(table_key, I64, (n,)),
           table_size=(table_size, I64, (n,)), keys=(keys, I64, (B,)))
    return _dispatch("bucket_lookup", dev, bucket_lookup,
                     ref.bucket_lookup_ref, table_key, table_size, keys,
                     assoc=assoc)


def metadata_update_op(freq, last_ts, slots, deltas, clock):
    """Combining FC-cache flush into fresh (freq, last_ts) f32[C]: at
    every slot s in [0, C) that ``slots`` i64[B] names, ``freq[s] +=``
    its deltas f32[B], added in batch order, and ``last_ts[s] =
    max(last_ts[s], clock)`` (a number or a 0-d f32 tensor); any other
    slot (-1) is a no-op.  Any C and B: the JAX op's ``block_c`` tiling,
    and its C % 512 == 0, are gone.  The JAX kernel sums a slot's deltas
    before it adds them, so on non-integer deltas the two may differ in
    the last bits."""
    dev = freq.device
    n, B = freq.shape[0], slots.shape[0]
    _check("metadata_update", dev, freq=(freq, F32, (n,)),
           last_ts=(last_ts, F32, (n,)), slots=(slots, I64, (B,)),
           deltas=(deltas, F32, (B,)))
    args = (freq, last_ts, slots, deltas,
            _clock("metadata_update", clock, dev))
    return _dispatch("metadata_update", dev, metadata_update,
                     ref.metadata_update_ref, *args)


def flash_attention_op(q, k, v):
    """Causal softmax attention, forward.  q: [B, T, H, D]; k, v:
    [B, T, H, D], or the GQA view [B, T, Hkv, R, D] with Hkv*R == H that
    ``models/attention.py::repeat_kv`` makes.  bf16 or f32; returns
    [B, T, H, D] in q's dtype."""
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q has shape {tuple(q.shape)}, "
                         "expected [B, T, H, D]")
    B, T, H, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             f"not {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
        if (x.dim() not in (4, 5) or tuple(x.shape[:2]) != (B, T)
                or x.shape[2:-1].numel() != H or x.shape[-1] != D):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(x.shape)} for q {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError("flash_attention: k and v differ in shape")
    if q.dtype not in (torch.bfloat16, F32):
        raise TypeError(f"flash_attention: q must be bf16 or f32, got "
                        f"{q.dtype}")
    if T == 0:
        raise ValueError("flash_attention: empty sequence")
    return _dispatch("flash_attention", dev, flash_attention,
                     ref.flash_attention_ref, q, k, v)
