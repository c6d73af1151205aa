"""The op wrappers of the hand-written kernels: the four cache kernels
of ``core.access`` (the probe with the insert path's bucket facts, the
in-place hit-metadata update, the ranked eviction, which also draws each
request's sample offset and expert choice, and the apply's
``drop_scatter``, one launch for all its write groups), the flash-attention
kernel of the LM prefill, and the three cache kernels that only this
entry point reaches (``sampled_eviction_op``, ``bucket_lookup_op``,
``metadata_update_op``, the JAX package's ``repro.kernels.ops`` forms).
A trailing underscore marks an op that updates its arguments in place.

Each wrapper checks its arguments (dtype, device, shape, contiguity) and
calls its operator (``kernels/library.py``, ``torch.ops.ditto.*``),
which dispatches on the device of the tensors it is given: CPU tensors
go to the plain version in ``kernels/ref.py``; CUDA tensors go to the
hand-written kernel, which is built at first use, and any failure to
build or launch raises; a tensor on any other device raises in the
dispatcher.  Fake and meta tensors take the operator's fake
implementation (shapes alone), so tracing tools see each kernel as one
operator.  Every kernel launch adds one to the kernel's
count on the device (``kernels/runtime.py``), also when the launch is
replayed from a CUDA graph (``core/cache.py::_scan``); :func:`launches`
reads the counts, so a run can show that its main path went through the
kernels.  The plain versions count nothing.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from repro_torch.kernels import library as lib
from repro_torch.kernels import ref
from repro_torch.kernels.runtime import launch_counts as launches
from repro_torch.kernels.runtime import reset_counts as reset_launches
from repro_torch.kernels.sampled_eviction import (KERNEL_EXPERTS, MAX_EXPERTS,
                                                  packed_codes)
from repro_torch.kernels.scatter import MAX_COLS, MAX_GROUPS

__all__ = ["access_probe_op", "hit_metadata_update_op",
           "hit_metadata_update_op_", "ranked_eviction_op",
           "ranked_eviction_draw_op", "drop_scatter_op_",
           "drop_scatter_groups_op_", "flash_attention_op",
           "sampled_eviction_op", "bucket_lookup_op", "metadata_update_op",
           "metadata_update_op_", "KERNEL_EXPERTS", "launches",
           "reset_launches"]

I64, F32, BOOL = torch.int64, torch.float32, torch.bool


def _device(op: str, device) -> None:
    """Only CPU (the plain versions) and CUDA (the kernels) tensors, real
    or fake, reach an operator: a meta tensor raises here."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {device}")


def _check(op: str, device, **tensors) -> None:
    """tensors: name -> (tensor, dtype, shape); a None dim matches any."""
    _device(op, device)
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


def _clock(op: str, clock, device) -> tuple:
    """A scalar clock as the ops take it, (tensor, number): a 0-d f32
    tensor on ``device`` as it is, or a number rounded to f32 (as
    ``jnp.asarray(clock, jnp.float32)`` rounds it)."""
    if isinstance(clock, torch.Tensor):
        _check(op, device, clock=(clock, F32, ()))
        return clock, 0.0
    if not isinstance(clock, numbers.Real):
        raise TypeError(f"{op}: clock must be a number or a 0-d tensor, got "
                        f"{type(clock).__name__}")
    return None, float(np.float32(clock))


def _experts(op: str, experts) -> tuple:
    experts = tuple(experts)
    bad = [e for e in experts if e not in KERNEL_EXPERTS]
    if bad:
        raise ValueError(f"{op} supports {KERNEL_EXPERTS}; got {bad}")
    return experts


def _eviction_experts(op: str, experts) -> tuple:
    """The eviction kernels' experts: 1 to MAX_EXPERTS of them, their
    codes passed by value."""
    experts = _experts(op, experts)
    if not 0 < len(experts) <= MAX_EXPERTS:
        raise ValueError(f"{op} takes 1 to {MAX_EXPERTS} experts, got "
                         f"{len(experts)}")
    return experts


def _window(op: str, window: int, k: int, n: int) -> None:
    if not 0 < window <= n:
        raise ValueError(f"{op}: window={window} for {n} slots")
    if not 0 < k <= window:
        raise ValueError(f"{op}: k={k} must be in [1, window={window}]")


def access_probe_op(table_key, table_size, table_hash, table_ptr, keys,
                    hist_ctr, *, assoc: int, history_len: int, meta=None,
                    ts=None, experts=None):
    """Bucket match + embedded-history match for u32 keys [B]: (found,
    slot, hist_found, hist_slot).  Given ``meta``, the table's
    (insert_ts, last_ts, freq) columns, with each op's timestamp ``ts``
    i64[B] and the ``experts``, a fifth output: the insert path's facts
    about each key's bucket (``ref.ProbeFacts``) from the same read."""
    dev = keys.device
    n = table_key.shape[0]
    B = keys.shape[0]
    if not 0 < assoc <= n or n % assoc:
        raise ValueError(f"access_probe: {n} slots is not a multiple of "
                         f"assoc={assoc}")
    spec = dict(table_key=(table_key, I64, (n,)),
                table_size=(table_size, I64, (n,)),
                table_hash=(table_hash, I64, (n,)),
                table_ptr=(table_ptr, I64, (n,)), keys=(keys, I64, (B,)),
                hist_ctr=(hist_ctr, I64, ()))
    if (meta is None) != (ts is None) or (meta is None) != (experts is None):
        raise ValueError("access_probe: meta, ts and experts go together")
    if meta is not None:
        if len(meta) != 3:
            raise ValueError("access_probe: meta is the (insert_ts, last_ts, "
                             "freq) columns")
        spec.update({f"meta{i}": (m, I64, (n,)) for i, m in enumerate(meta)},
                    ts=(ts, I64, (B,)))
        experts = _experts("access_probe", experts)
    _check("access_probe", dev, **spec)
    args = (table_key, table_size, table_hash, table_ptr, keys, hist_ctr)
    if meta is None:
        return lib.access_probe_op(*args, assoc, history_len)
    out = lib.access_probe_facts_op(*args, *meta, ts, assoc, history_len,
                                    packed_codes(experts), len(experts))
    return tuple(out[:4]) + (ref.ProbeFacts(*out[4:]),)


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
    lib.hit_metadata_update_op_(freq, last_ts, ext, hit_slots, hit_ts,
                                emit_slots, emit_deltas)


def hit_metadata_update_op(freq, last_ts, ext, hit_slots, hit_ts, emit_slots,
                           emit_deltas):
    """:func:`hit_metadata_update_op_` into fresh (freq, last_ts, ext)
    tensors, as the JAX op returns them; the inputs stay as they are."""
    out = (freq.clone(), last_ts.clone(), ext.clone())
    hit_metadata_update_op_(*out, hit_slots, hit_ts, emit_slots, emit_deltas)
    return out


def _scatter_source(k, col, src, B: int, spec: dict) -> None:
    """Check source ``k`` of ``col``: a [B] or [B, W] tensor of the
    column's dtype, an integer (an int64 column), or ``(cond, a, b)``
    with ``cond`` bool[B] and ``a``, ``b`` each of the first two forms."""
    if isinstance(src, tuple):
        if len(src) != 3:
            raise TypeError(f"drop_scatter: source {k} is (cond, a, b)")
        spec[f"cond{k}"] = (src[0], BOOL, (B,))
        for part, x in zip("ab", src[1:]):
            if isinstance(x, tuple):
                raise TypeError(f"drop_scatter: source {k}{part} is a tensor "
                                "or an integer")
            _scatter_source(f"{k}{part}", col, x, B, spec)
    elif torch.is_tensor(src):
        spec[f"src{k}"] = (src, col.dtype, (B,) + tuple(col.shape[1:]))
    elif not (isinstance(src, numbers.Integral) and col.dtype == I64):
        raise TypeError(f"drop_scatter: source {k} must be a tensor, an "
                        "integer for an int64 column, or (cond, a, b)")


def _scatter_group(group, dev) -> tuple:
    """A checked write group (idx, cols, srcs, mask)."""
    if len(group) not in (3, 4):
        raise ValueError("drop_scatter: a group is (idx, cols, srcs) or "
                         "(idx, cols, srcs, mask)")
    idx, cols, srcs, mask = (*group, None)[:4]
    B = idx.shape[0]
    if not 0 < len(cols) == len(srcs) <= MAX_COLS:
        raise ValueError(f"drop_scatter: {len(cols)} columns and "
                         f"{len(srcs)} sources (1 to {MAX_COLS} of each)")
    n = cols[0].shape[0]
    if n >= 2**31 or B >= 2**31:
        raise ValueError(f"drop_scatter: {n} rows, {B} entries (each under "
                         "2^31)")
    spec = dict(idx=(idx, I64, (B,)))
    if mask is not None:
        spec["mask"] = (mask, BOOL, (B,))
    for k, (col, src) in enumerate(zip(cols, srcs)):
        if col.dtype not in (I64, F32) or col.dim() not in (1, 2):
            raise TypeError(f"drop_scatter: column {k} is {col.dtype} of "
                            f"{col.dim()} dims (int64 or f32, 1 or 2 dims)")
        spec[f"col{k}"] = (col, col.dtype, (n,) + tuple(col.shape[1:]))
        _scatter_source(k, col, src, B, spec)
    _check("drop_scatter", dev, **spec)
    return idx, tuple(cols), tuple(srcs), mask


def drop_scatter_op_(idx, cols, srcs, mask=None) -> None:
    """In place, for each column of ``cols`` (all of one length n, [n] or
    [n, W], int64 or f32): ``col[idx[b]] = src[b]`` where
    ``0 <= idx[b] < n`` and ``mask[b]`` (bool[B], if given), and nothing
    for any other entry (``idx`` i64[B]).  Each ``src`` is a [B] or
    [B, W] tensor of its column's dtype, an integer written to every such
    row of an int64 column, or ``(cond, a, b)``: ``a`` where ``cond[b]``,
    else ``b``, each a tensor or an integer.  Kept in-range indices must
    be unique, or their entries write equal rows; no source may be a
    column written."""
    drop_scatter_groups_op_(((idx, cols, srcs, mask),))


def drop_scatter_groups_op_(groups) -> None:
    """:func:`drop_scatter_op_` for each group ``(idx, cols, srcs)`` or
    ``(idx, cols, srcs, mask)`` in order, in one launch on the card: a
    later group's write of a (row, column) wins over an earlier one's.
    At most ``MAX_GROUPS`` groups and ``MAX_COLS`` columns in all."""
    groups = tuple(groups)
    if not 0 < len(groups) <= MAX_GROUPS:
        raise ValueError(f"drop_scatter: {len(groups)} groups (1 to "
                         f"{MAX_GROUPS})")
    dev = groups[0][0].device
    groups = tuple(_scatter_group(g, dev) for g in groups)
    if sum(len(g[1]) for g in groups) > MAX_COLS:
        raise ValueError(f"drop_scatter: more than {MAX_COLS} columns in all")
    lib.drop_scatter_op_(*lib.pack_groups(groups))


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
    experts = _eviction_experts("ranked_eviction", experts)
    _window("ranked_eviction", window, k, n)
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
    return lib.ranked_eviction_op(
        size, insert_ts, last_ts, freq, offsets, e_choice, must_evict, quota,
        ts, tenant, tfilt, window, k, packed_codes(experts), len(experts))


def ranked_eviction_draw_op(size, insert_ts, last_ts, freq, rng, cdf,
                            must_evict, quota, ts, *, window: int, k: int,
                            experts, tenant=None, tfilt=None, op_tenant=None):
    """:func:`ranked_eviction_op` that draws each op's window offset and
    expert choice itself, as the cache step does: op b's key is
    ``rng[b % lanes]`` (``ClientState.rng``, [lanes, 2] u32), folded with
    its timestamp ``ts[b]`` into two uniforms; the offset is the second
    scaled to the table, the choice the number of the lane's ``cdf``
    entries ([lanes, E] f32) below the first (E takes no victim).  With
    ``op_tenant`` i64[B] (each op's tenant id, clamped into [0, T)) the
    cdf is [lanes, T, E] and op b reads row ``(b % lanes,
    op_tenant[b])``; ``tenant`` [C] with ``tfilt`` i64[B] scopes an op's
    sample, as in :func:`ranked_eviction_op`.  Returns victims i64[B, k],
    cand i64[B, E], e_choice i64[B] and each victim entry's expert bitmap
    i64[B, k] (the candidates it equals, and the chosen expert).  One
    launch, counted as ``ranked_eviction``."""
    dev = ts.device
    n, B = size.shape[0], ts.shape[0]
    experts = _eviction_experts("ranked_eviction", experts)
    _window("ranked_eviction", window, k, n)
    lanes = rng.shape[0] if rng.dim() else 0
    if lanes == 0:
        raise ValueError("ranked_eviction: rng needs at least one lane")
    E = len(experts)
    spec = dict(size=(size, I64, (n,)), insert_ts=(insert_ts, I64, (n,)),
                last_ts=(last_ts, I64, (n,)), freq=(freq, I64, (n,)),
                rng=(rng, I64, (lanes, 2)),
                cdf=(cdf, F32, (lanes, E) if op_tenant is None
                     else (lanes, None, E)),
                must_evict=(must_evict, BOOL, (B,)),
                quota=(quota, I64, (B,) if quota.dim() else ()),
                ts=(ts, I64, (B,)))
    if op_tenant is not None:
        spec["op_tenant"] = (op_tenant, I64, (B,))
        if cdf.dim() == 3 and cdf.shape[1] == 0:
            raise ValueError("ranked_eviction: cdf needs at least one tenant")
    if (tenant is None) != (tfilt is None):
        raise ValueError("ranked_eviction: tenant and tfilt go together")
    if tenant is not None:
        spec.update(tenant=(tenant, I64, (n,)), tfilt=(tfilt, I64, (B,)))
    _check("ranked_eviction", dev, **spec)
    return lib.ranked_eviction_draw_op(
        size, insert_ts, last_ts, freq, rng, cdf, must_evict, quota, ts,
        tenant, tfilt, op_tenant, window, k, packed_codes(experts), E)


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
    experts = _eviction_experts("sampled_eviction", experts)
    if not 0 < window <= n:
        raise ValueError(f"sampled_eviction: window={window} for {n} "
                         "padded slots")
    _check("sampled_eviction", dev, size=(size, F32, (n,)),
           insert_ts=(insert_ts, F32, (n,)), last_ts=(last_ts, F32, (n,)),
           freq=(freq, F32, (n,)), offsets=(offsets, I64, (B,)),
           e_choice=(e_choice, I64, (B,)))
    clock_t, clock = _clock("sampled_eviction", clock, dev)
    if not 0 < k <= window:
        raise ValueError(f"sampled_eviction: k={k} must be in [1, window="
                         f"{window}]")
    return lib.sampled_eviction_op(size, insert_ts, last_ts, freq, offsets,
                                   e_choice, clock_t, clock, window, k,
                                   packed_codes(experts), len(experts))


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
    return lib.bucket_lookup_op(table_key, table_size, keys, assoc)


def metadata_update_op(freq, last_ts, slots, deltas, clock):
    """Combining FC-cache flush into fresh (freq, last_ts) f32[C]: at
    every slot s in [0, C) that ``slots`` i64[B] names, ``freq[s] +=``
    its deltas f32[B], added in batch order, and ``last_ts[s] =
    max(last_ts[s], clock)`` (a number or a 0-d f32 tensor); any other
    slot (-1) is a no-op.  Any C and B: the JAX op's ``block_c`` tiling,
    and its C % 512 == 0, are gone.  The JAX kernel sums a slot's deltas
    before it adds them, so on non-integer deltas the two may differ in
    the last bits."""
    return lib.metadata_update_op(*_metadata_args(freq, last_ts, slots,
                                                  deltas, clock))


def metadata_update_op_(freq, last_ts, slots, deltas, clock) -> None:
    """:func:`metadata_update_op` in place in ``freq`` and ``last_ts``
    (on the card no copy of the columns)."""
    lib.metadata_update_op_(*_metadata_args(freq, last_ts, slots, deltas,
                                            clock))


def _metadata_args(freq, last_ts, slots, deltas, clock) -> tuple:
    dev = freq.device
    n, B = freq.shape[0], slots.shape[0]
    _check("metadata_update", dev, freq=(freq, F32, (n,)),
           last_ts=(last_ts, F32, (n,)), slots=(slots, I64, (B,)),
           deltas=(deltas, F32, (B,)))
    return (freq, last_ts, slots, deltas,
            *_clock("metadata_update", clock, dev))


def flash_attention_op(q, k, v):
    """Causal softmax attention, forward.  q: [B, T, H, D]; k, v:
    [B, T, H, D], or the GQA view [B, T, Hkv, R, D] with Hkv*R == H that
    ``models/attention.py::repeat_kv`` makes.  bf16 or f32; returns
    [B, T, H, D] in q's dtype.

    Forward only: the kernel's output has no ``grad_fn``, so with grad
    mode on and any input requiring grad it raises, on every device
    alike, rather than drop the gradient."""
    dev = q.device
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the op is forward only and its inputs "
            "require grad; the training path takes the plain attention "
            "(models/attention.py::full_attention or chunked_attention, "
            "attention_block(..., plain=True), as forward() with labels "
            "does)")
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
    _device("flash_attention", dev)
    return lib.flash_attention_op(q, k, v)
