"""The op wrappers of the hand-written kernels: the three cache kernels
of ``core.access`` and the flash-attention kernel of the LM prefill.

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

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bucket_lookup import access_probe
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.metadata_update import hit_metadata_update
from repro_torch.kernels.runtime import launch_counts as launches
from repro_torch.kernels.runtime import reset_counts as reset_launches
from repro_torch.kernels.sampled_eviction import (KERNEL_EXPERTS, MAX_SAMPLES,
                                                  ranked_eviction)

__all__ = ["access_probe_op", "hit_metadata_update_op", "ranked_eviction_op",
           "flash_attention_op", "KERNEL_EXPERTS", "launches",
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


def hit_metadata_update_op(freq, last_ts, ext, hit_slots, hit_ts, emit_slots,
                           emit_deltas):
    """Hit-slot last_ts/ext update and FC-flush freq FAA, into fresh
    (freq, last_ts, ext) tensors."""
    dev = freq.device
    n, bh, be = freq.shape[0], hit_slots.shape[0], emit_slots.shape[0]
    _check("hit_metadata_update", dev, freq=(freq, I64, (n,)),
           last_ts=(last_ts, I64, (n,)), ext=(ext, F32, (n, 4)),
           hit_slots=(hit_slots, I64, (bh,)), hit_ts=(hit_ts, I64, (bh,)),
           emit_slots=(emit_slots, I64, (be,)),
           emit_deltas=(emit_deltas, I64, (be,)))
    args = (freq, last_ts, ext, hit_slots, hit_ts, emit_slots, emit_deltas)
    return _dispatch("hit_metadata_update", dev, hit_metadata_update,
                     ref.hit_metadata_update_ref, *args)


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
    experts = tuple(experts)
    bad = [e for e in experts if e not in KERNEL_EXPERTS]
    if bad:
        raise ValueError(f"ranked_eviction supports {KERNEL_EXPERTS}; "
                         f"got {bad}")
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
