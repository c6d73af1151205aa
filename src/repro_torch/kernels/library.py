"""The hand-written kernels as PyTorch operators (``torch.ops.ditto.*``).

Each kernel of ``kernels/csrc`` is a ``torch.library`` operator: its
CUDA implementation is the launcher (``bucket_lookup.py``,
``flash_attention.py``, ``metadata_update.py``, ``sampled_eviction.py``,
``scatter.py``), which builds the kernel at first use, counts the launch
on the device (``kernels/runtime.py``) and raises on any failure; its CPU
implementation is the plain version in ``kernels/ref.py``.  No other
device has an implementation, so a tensor anywhere else raises in the
dispatcher: there is no fallback.

Each op also has a fake implementation (``register_fake``: the output
shapes and dtypes alone), so fake tensors, ``make_fx``, the cost counter
of ``launch/op_cost.py`` and DTensor see the kernel as one operator with
its inputs and outputs, where a ctypes launch would be invisible.  The
ops that write their arguments declare them in their schemas
(``mutates_args``): ``hit_metadata_update_``, ``drop_scatter_`` and
``metadata_update_``.  The flash op has a FLOP formula (causal: half of
the 2 * 2 * B * H * T^2 * D of the two products) and a DTensor sharding
rule (replicated, or sharded on the batch or on the heads), registered
when a mesh is first used (:func:`register_sharding_rules`).

The checked wrappers in ``kernels/ops.py`` are the entry points; these
ops take what the wrappers pass on.  Experts go as their codes, four
bits each (``sampled_eviction.packed_codes``), and a write group's
sources as flat lists (:func:`pack_groups`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import ref
from repro_torch.kernels.bucket_lookup import access_probe, bucket_lookup
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.metadata_update import (hit_metadata_update_,
                                                 metadata_update,
                                                 metadata_update_into)
from repro_torch.kernels.sampled_eviction import (KERNEL_EXPERTS,
                                                  ranked_eviction,
                                                  ranked_eviction_draw,
                                                  sampled_eviction)
from repro_torch.kernels.scatter import drop_scatter

NS = "ditto"
I64, BOOL = torch.int64, torch.bool


def experts_of(codes: int, n: int) -> tuple:
    """The expert names of ``n`` codes packed four bits each."""
    return tuple(KERNEL_EXPERTS[(codes >> (4 * e)) & 15] for e in range(n))


_LIB = torch.library.Library(NS, "DEF")


class _Op:
    """The operator ``ditto::name``: called as its ``OpOverload``; its CUDA
    kernel and its fake implementation are added as ``custom_op``'s are
    (``register_kernel("cuda")``, ``register_fake``)."""

    def __init__(self, name: str):
        self.name = name
        self.default = getattr(getattr(torch.ops, NS), name).default

    def __call__(self, *args):
        return self.default(*args)

    def register_kernel(self, device: str):
        def add(fn):
            _LIB.impl(self.name, fn, device.upper())
            return fn
        return add

    def register_fake(self, fn):
        torch.library.register_fake(f"{NS}::{self.name}", fn, lib=_LIB)
        return fn


def _op(name: str, mutates=()):
    """The decorated function as the CPU implementation of a new operator
    ``ditto::name``, its schema read from its annotations.  Registered on
    ``torch.library``'s low-level API: ``torch.library.custom_op`` wraps
    each implementation in a layer that imports ``torch._dynamo`` at the
    first call (seconds of a process's first request) and adds Python
    frames to every call."""
    def define(fn):
        _LIB.define(name + torch.library.infer_schema(fn,
                                                      mutates_args=mutates))
        _LIB.impl(name, fn, "CPU")
        return _Op(name)
    return define


def _new(like: Tensor, shape, dtype) -> Tensor:
    return like.new_empty(shape, dtype=dtype)


# ---------------------------------------------------------------------
# access_probe (row 1), alone and with the insert path's facts
# ---------------------------------------------------------------------

@_op("access_probe")
def access_probe_op(table_key: Tensor, table_size: Tensor, table_hash: Tensor,
                    table_ptr: Tensor, keys: Tensor, hist_ctr: Tensor,
                    assoc: int, history_len: int
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return ref.access_probe_ref(table_key, table_size, table_hash, table_ptr,
                                keys, hist_ctr, assoc=assoc,
                                history_len=history_len)


@access_probe_op.register_kernel("cuda")
def _(table_key, table_size, table_hash, table_ptr, keys, hist_ctr, assoc,
      history_len):
    return access_probe(table_key, table_size, table_hash, table_ptr, keys,
                        hist_ctr, assoc=assoc, history_len=history_len)


@access_probe_op.register_fake
def _(table_key, table_size, table_hash, table_ptr, keys, hist_ctr, assoc,
      history_len):
    B = keys.shape[0]
    return (_new(keys, (B,), BOOL), _new(keys, (B,), I64),
            _new(keys, (B,), BOOL), _new(keys, (B,), I64))


def _facts(table_key, table_size, table_hash, table_ptr, keys, hist_ctr,
           insert_ts, last_ts, freq, ts, assoc, history_len, codes, n_exp,
           fn):
    out = fn(table_key, table_size, table_hash, table_ptr, keys, hist_ctr,
             assoc=assoc, history_len=history_len,
             meta=(insert_ts, last_ts, freq), ts=ts,
             experts=experts_of(codes, n_exp))
    return tuple(out[:4]) + tuple(out[4])


@_op("access_probe_facts")
def access_probe_facts_op(table_key: Tensor, table_size: Tensor,
                          table_hash: Tensor, table_ptr: Tensor, keys: Tensor,
                          hist_ctr: Tensor, insert_ts: Tensor,
                          last_ts: Tensor, freq: Tensor, ts: Tensor,
                          assoc: int, history_len: int, codes: int,
                          n_experts: int) -> List[Tensor]:
    return list(_facts(table_key, table_size, table_hash, table_ptr, keys,
                       hist_ctr, insert_ts, last_ts, freq, ts, assoc,
                       history_len, codes, n_experts, ref.access_probe_ref))


@access_probe_facts_op.register_kernel("cuda")
def _(table_key, table_size, table_hash, table_ptr, keys, hist_ctr,
      insert_ts, last_ts, freq, ts, assoc, history_len, codes, n_experts):
    return list(_facts(table_key, table_size, table_hash, table_ptr, keys,
                       hist_ctr, insert_ts, last_ts, freq, ts, assoc,
                       history_len, codes, n_experts, access_probe))


@access_probe_facts_op.register_fake
def _(table_key, table_size, table_hash, table_ptr, keys, hist_ctr,
      insert_ts, last_ts, freq, ts, assoc, history_len, codes, n_experts):
    B = keys.shape[0]
    i, b = (lambda: _new(keys, (B,), I64)), (lambda: _new(keys, (B,), BOOL))
    # (found, slot, hist_found, hist_slot) and ref.ProbeFacts' fields.
    return [b(), i(), b(), i(), i(), i(), i(), b(), i(), b(), b(),
            _new(keys, (B, n_experts + 1), I64)]


# ---------------------------------------------------------------------
# hit_metadata_update (row 2), in place
# ---------------------------------------------------------------------

@_op("hit_metadata_update_", mutates=("freq", "last_ts", "ext"))
def hit_metadata_update_op_(freq: Tensor, last_ts: Tensor, ext: Tensor,
                            hit_slots: Tensor, hit_ts: Tensor,
                            emit_slots: Tensor, emit_deltas: Tensor) -> None:
    ref.hit_metadata_update_ref_(freq, last_ts, ext, hit_slots, hit_ts,
                                 emit_slots, emit_deltas)


hit_metadata_update_op_.register_kernel("cuda")(hit_metadata_update_)


@hit_metadata_update_op_.register_fake
def _(freq, last_ts, ext, hit_slots, hit_ts, emit_slots, emit_deltas):
    return None


# ---------------------------------------------------------------------
# ranked_eviction (row 3): given offsets and choices, or drawing them
# ---------------------------------------------------------------------

@_op("ranked_eviction")
def ranked_eviction_op(size: Tensor, insert_ts: Tensor, last_ts: Tensor,
                       freq: Tensor, offsets: Tensor, e_choice: Tensor,
                       must_evict: Tensor, quota: Tensor, ts: Tensor,
                       tenant: Optional[Tensor], tfilt: Optional[Tensor],
                       window: int, k: int, codes: int, n_experts: int
                       ) -> Tuple[Tensor, Tensor]:
    return ref.ranked_eviction_ref(
        size, insert_ts, last_ts, freq, offsets, e_choice, must_evict, quota,
        ts, window=window, k=k, experts=experts_of(codes, n_experts),
        tenant=tenant, tfilt=tfilt)


@ranked_eviction_op.register_kernel("cuda")
def _(size, insert_ts, last_ts, freq, offsets, e_choice, must_evict, quota,
      ts, tenant, tfilt, window, k, codes, n_experts):
    return ranked_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                           must_evict, quota, ts, window=window, k=k,
                           experts=experts_of(codes, n_experts),
                           tenant=tenant, tfilt=tfilt)


@ranked_eviction_op.register_fake
def _(size, insert_ts, last_ts, freq, offsets, e_choice, must_evict, quota,
      ts, tenant, tfilt, window, k, codes, n_experts):
    B = offsets.shape[0]
    return _new(offsets, (B, k), I64), _new(offsets, (B, n_experts), I64)


@_op("ranked_eviction_draw")
def ranked_eviction_draw_op(size: Tensor, insert_ts: Tensor, last_ts: Tensor,
                            freq: Tensor, rng: Tensor, cdf: Tensor,
                            must_evict: Tensor, quota: Tensor, ts: Tensor,
                            tenant: Optional[Tensor], tfilt: Optional[Tensor],
                            op_tenant: Optional[Tensor], window: int, k: int,
                            codes: int, n_experts: int
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return ref.ranked_eviction_draw_ref(
        size, insert_ts, last_ts, freq, rng, cdf, must_evict, quota, ts,
        window=window, k=k, experts=experts_of(codes, n_experts),
        tenant=tenant, tfilt=tfilt, op_tenant=op_tenant)


@ranked_eviction_draw_op.register_kernel("cuda")
def _(size, insert_ts, last_ts, freq, rng, cdf, must_evict, quota, ts,
      tenant, tfilt, op_tenant, window, k, codes, n_experts):
    return ranked_eviction_draw(
        size, insert_ts, last_ts, freq, rng, cdf, must_evict, quota, ts,
        window=window, k=k, experts=experts_of(codes, n_experts),
        tenant=tenant, tfilt=tfilt, op_tenant=op_tenant)


@ranked_eviction_draw_op.register_fake
def _(size, insert_ts, last_ts, freq, rng, cdf, must_evict, quota, ts,
      tenant, tfilt, op_tenant, window, k, codes, n_experts):
    B = ts.shape[0]
    return (_new(ts, (B, k), I64), _new(ts, (B, n_experts), I64),
            _new(ts, (B,), I64), _new(ts, (B, k), I64))


# ---------------------------------------------------------------------
# drop_scatter (the port's row 8): write groups, in place
# ---------------------------------------------------------------------

def pack_groups(groups) -> tuple:
    """Checked groups ``(idx, cols, srcs, mask)`` as the op's flat lists:
    (idx, masks, ncols, cols, conds, a_t, a_i, b_t, b_i), a source
    ``s`` being ``(None, s, 0)`` and ``(cond, a, b)`` as it is, each
    part a tensor (``*_t``) or an integer (``*_i``)."""
    idx, masks, ncols, cols = [], [], [], []
    conds, a_t, a_i, b_t, b_i = [], [], [], [], []
    for g_idx, g_cols, g_srcs, g_mask in groups:
        idx.append(g_idx)
        masks.append(g_mask)
        ncols.append(len(g_cols))
        for col, src in zip(g_cols, g_srcs):
            cond, a, b = src if isinstance(src, tuple) else (None, src, 0)
            cols.append(col)
            conds.append(cond)
            for x, ts_, is_ in ((a, a_t, a_i), (b, b_t, b_i)):
                ts_.append(x if torch.is_tensor(x) else None)
                is_.append(0 if torch.is_tensor(x) else int(x))
    return idx, masks, ncols, cols, conds, a_t, a_i, b_t, b_i


def _unpack_groups(idx, masks, ncols, cols, conds, a_t, a_i, b_t, b_i):
    groups, c = [], 0
    for g_idx, g_mask, n in zip(idx, masks, ncols):
        srcs = []
        for j in range(c, c + n):
            a = a_t[j] if a_t[j] is not None else a_i[j]
            b = b_t[j] if b_t[j] is not None else b_i[j]
            srcs.append(a if conds[j] is None else (conds[j], a, b))
        groups.append((g_idx, tuple(cols[c:c + n]), tuple(srcs), g_mask))
        c += n
    return tuple(groups)


@_op("drop_scatter_", mutates=("cols",))
def drop_scatter_op_(idx: Sequence[Tensor], masks: Sequence[Optional[Tensor]],
                     ncols: Sequence[int], cols: Sequence[Tensor],
                     conds: Sequence[Optional[Tensor]],
                     a_t: Sequence[Optional[Tensor]], a_i: Sequence[int],
                     b_t: Sequence[Optional[Tensor]], b_i: Sequence[int]
                     ) -> None:
    ref.drop_scatter_groups_ref(_unpack_groups(idx, masks, ncols, cols, conds,
                                               a_t, a_i, b_t, b_i))


@drop_scatter_op_.register_kernel("cuda")
def _(idx, masks, ncols, cols, conds, a_t, a_i, b_t, b_i):
    drop_scatter(_unpack_groups(idx, masks, ncols, cols, conds, a_t, a_i,
                                b_t, b_i))


@drop_scatter_op_.register_fake
def _(idx, masks, ncols, cols, conds, a_t, a_i, b_t, b_i):
    return None


# ---------------------------------------------------------------------
# flash_attention (row 7)
# ---------------------------------------------------------------------

@_op("flash_attention")
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    return ref.flash_attention_ref(q, k, v)


flash_attention_op.register_kernel("cuda")(flash_attention)


@flash_attention_op.register_fake
def _(q, k, v):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def flash_flops(q_shape, *_, **__) -> int:
    """Causal attention's products: QK^T and PV, 2 * B * H * T * T * D
    FLOPs each, half of them under the causal mask."""
    B, T, H, D = q_shape
    return 2 * 2 * B * H * T * T * D // 2


# ---------------------------------------------------------------------
# the entry point's three kernels (rows 4-6)
# ---------------------------------------------------------------------

@_op("sampled_eviction")
def sampled_eviction_op(size: Tensor, insert_ts: Tensor, last_ts: Tensor,
                        freq: Tensor, offsets: Tensor, e_choice: Tensor,
                        clock_t: Optional[Tensor], clock: float, window: int,
                        k: int, codes: int, n_experts: int
                        ) -> Tuple[Tensor, Tensor]:
    return ref.sampled_eviction_ref(
        size, insert_ts, last_ts, freq, offsets, e_choice,
        clock if clock_t is None else clock_t, window=window, k=k,
        experts=experts_of(codes, n_experts))


@sampled_eviction_op.register_kernel("cuda")
def _(size, insert_ts, last_ts, freq, offsets, e_choice, clock_t, clock,
      window, k, codes, n_experts):
    return sampled_eviction(size, insert_ts, last_ts, freq, offsets, e_choice,
                            clock if clock_t is None else clock_t,
                            window=window, k=k,
                            experts=experts_of(codes, n_experts))


@sampled_eviction_op.register_fake
def _(size, insert_ts, last_ts, freq, offsets, e_choice, clock_t, clock,
      window, k, codes, n_experts):
    B = offsets.shape[0]
    return _new(offsets, (B,), I64), _new(offsets, (B, n_experts), I64)


@_op("bucket_lookup")
def bucket_lookup_op(table_key: Tensor, table_size: Tensor, keys: Tensor,
                     assoc: int) -> Tuple[Tensor, Tensor]:
    return ref.bucket_lookup_ref(table_key, table_size, keys, assoc=assoc)


@bucket_lookup_op.register_kernel("cuda")
def _(table_key, table_size, keys, assoc):
    return bucket_lookup(table_key, table_size, keys, assoc=assoc)


@bucket_lookup_op.register_fake
def _(table_key, table_size, keys, assoc):
    B = keys.shape[0]
    return _new(keys, (B,), BOOL), _new(keys, (B,), I64)


@_op("metadata_update")
def metadata_update_op(freq: Tensor, last_ts: Tensor, slots: Tensor,
                       deltas: Tensor, clock_t: Optional[Tensor],
                       clock: float) -> Tuple[Tensor, Tensor]:
    return ref.metadata_update_ref(freq, last_ts, slots, deltas,
                                   clock if clock_t is None else clock_t)


@metadata_update_op.register_kernel("cuda")
def _(freq, last_ts, slots, deltas, clock_t, clock):
    return metadata_update(freq, last_ts, slots, deltas,
                           clock if clock_t is None else clock_t)


@metadata_update_op.register_fake
def _(freq, last_ts, slots, deltas, clock_t, clock):
    return torch.empty_like(freq), torch.empty_like(last_ts)


@_op("metadata_update_", mutates=("freq", "last_ts"))
def metadata_update_op_(freq: Tensor, last_ts: Tensor, slots: Tensor,
                        deltas: Tensor, clock_t: Optional[Tensor],
                        clock: float) -> None:
    new = ref.metadata_update_ref(freq, last_ts, slots, deltas,
                                  clock if clock_t is None else clock_t)
    for col, x in zip((freq, last_ts), new):
        col.copy_(x)


@metadata_update_op_.register_kernel("cuda")
def _(freq, last_ts, slots, deltas, clock_t, clock):
    metadata_update_into(freq, last_ts, slots, deltas,
                         clock if clock_t is None else clock_t, freq, last_ts)


@metadata_update_op_.register_fake
def _(freq, last_ts, slots, deltas, clock_t, clock):
    return None


OPS = {"access_probe": (access_probe_op, access_probe_facts_op),
       "hit_metadata_update": (hit_metadata_update_op_,),
       "ranked_eviction": (ranked_eviction_op, ranked_eviction_draw_op),
       "drop_scatter": (drop_scatter_op_,),
       "flash_attention": (flash_attention_op,),
       "sampled_eviction": (sampled_eviction_op,),
       "bucket_lookup": (bucket_lookup_op,),
       "metadata_update": (metadata_update_op, metadata_update_op_)}


def _register_flops() -> None:
    """The flash op's FLOP formula (``torch.utils.flop_counter``)."""
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.ditto.flash_attention)(
        lambda q_shape, k_shape, v_shape, out_shape=None, **kw:
        flash_flops(q_shape))


_register_flops()


def register_sharding_rules() -> None:
    """The flash op's DTensor sharding rule: each strategy is (output
    placements, input placements) on one mesh dim, which DTensor expands
    over the mesh.  The heads shard when q's heads and k's and v's head
    axis (Hkv of the GQA view [B, T, Hkv, R, D], or H) split alike.
    Registered by ``models.sharding.use_mesh``, the first time a mesh is
    used: DTensor's import costs a second."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.ditto.flash_attention.default)
    def _flash_sharding(q, k, v):
        rep = [Replicate()]
        return [(rep, rep * 3), ([Shard(0)], [Shard(0)] * 3),
                ([Shard(2)], [Shard(2)] * 3)]
