"""Per-device cost of one run of a step, counted op by op: the port's
counterpart of ``repro/launch/hlo_cost.py`` (which reads compiled HLO).

:class:`OpCounter` is a ``TorchDispatchMode``.  Entered around one call
of a step, on real or fake tensors, it sees every operator the step
dispatches, the hand-written kernels among them (``torch.ops.ditto.*``,
``kernels/library.py``), and reports what ``CostReport`` reports:

  * **FLOPs**: products from PyTorch's formulas
    (``torch.utils.flop_counter``: ``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolutions, attention), the flash kernel from its
    registered formula (causal: half of 2 * 2 * B * H * T^2 * D);
  * **bytes**: operand plus result bytes of every dispatched op that
    moves data (views, allocations and metadata ops move none): the
    pessimistic, op-granularity figure, as HLO granularity is JAX's;
  * **fused bytes**: the optimistic figure: each product's operands and
    result at bf16, the rows a gather reads or a scatter writes (twice:
    read and write), and the collectives' bytes;
  * **collective bytes and counts**, by kind (JAX's names), from the
    ``c10d_functional`` ops DTensor's redistributions dispatch: result
    bytes, an all-reduce twice (its reduce-scatter and all-gather
    phases).

The counts are **per device, of the local program**.  A DTensor op is
not counted where it is dispatched (its global shape is not any
device's work): the counter declines it (``NotImplemented``), DTensor
runs it on the local shards, and those ops come back through the mode
and are counted.  So a replicated product counts once on every device,
as XLA's per-device module counts it, and a sharded one counts its
shard.  DTensor's own shape propagation (it runs each new op once on
global-shaped fake tensors) is not counted: the counter pauses while
``ShardingPropagator._propagate_tensor_meta_non_cached`` runs.

Eager dispatch sees every iteration of every loop (the periods, the
microbatches, an sLSTM's time steps, a remat's recompute in the
backward), so ``hlo_cost``'s walk of while-loop trip counts has no
counterpart here.

The counter also tracks memory: the bytes of the storages that the
step's ops create and that are still alive (a weak reference to each
storage; its bytes leave when it is freed), and their peak, over the
local shards.  That is a dispatch-mode tracker of its own, not
``torch.distributed._tools.mem_tracker``; with fake tensors it counts
what the step would allocate, not the caching allocator's blocks.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.kernels.library  # noqa: F401  (the ops' formulas)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d_functional / c10d op names -> JAX's collective kinds.
_KIND = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
         "all_gather": "all-gather", "allgather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "alltoall": "all-to-all", "broadcast": "collective-permute",
         "send": "collective-permute", "recv": "collective-permute",
         "permute": "collective-permute"}
# aten ops that move no data: views, allocations, metadata.
_NO_BYTES = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "view_as", "alias", "as_strided", "detach", "select",
    "slice", "unsqueeze", "squeeze", "permute", "transpose", "t", "unbind",
    "split", "split_with_sizes", "chunk", "narrow", "diagonal", "unfold",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "is_same_size",
    "is_nonzero", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "lift_fresh", "_has_compatible_shallow_copy_type"))
_PRODUCTS = frozenset(("mm", "bmm", "addmm", "baddbmm", "convolution",
                       "_scaled_dot_product_flash_attention",
                       "_scaled_dot_product_efficient_attention",
                       "flash_attention"))
_GATHERS = frozenset(("index", "index_select", "gather", "embedding",
                      "take_along_dim"))
_SCATTERS = frozenset(("index_put", "index_put_", "_index_put_impl_",
                       "scatter", "scatter_", "scatter_add", "scatter_add_",
                       "index_add", "index_add_", "index_copy",
                       "index_copy_"))


class CostReport(NamedTuple):
    flops: float
    bytes: float          # op-granularity traffic
    fused_bytes: float    # products at bf16 + gathers/scatters + collectives
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    coll_counts: Dict[str, float]


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors of an op's arguments or results: tensors, and those in
    lists, tuples and dicts (nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    out = []
    for a in x:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple, dict)):
            out.extend(_tensors(a))
    return out


def _kind(name: str):
    """The collective kind of an op name, or None."""
    if "c10d" not in name:
        return None
    for key, kind in _KIND.items():
        if key in name:
            return kind
    return None


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


class OpCounter(TorchDispatchMode):
    """Count FLOPs, bytes, fused bytes and collectives of every op run
    under it (see the module docstring), and the live bytes of the
    storages those ops create.  ``by_op`` holds (calls, FLOPs, bytes)
    per op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.fused = 0.0
        self.coll = dict.fromkeys(COLLECTIVES, 0.0)
        self.coll_n = dict.fromkeys(COLLECTIVES, 0.0)
        self.by_op: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0, 0.0])
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._DTensor = _dtensor()
        self._paused = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        self._prop = prop

        def paused(*args, **kwargs):
            self._paused += 1
            try:
                return prop(*args, **kwargs)
            finally:
                self._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, self._DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused or any(t.device.type == "meta" for t in ins):
            return out
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        name = str(func)
        outs = _tensors(out)
        rec = self.by_op[name]
        rec[0] += 1
        kind = _kind(name)
        if kind is not None:
            b = sum(_bytes(t) for t in outs) or sum(_bytes(t) for t in ins)
            self.coll[kind] += 2 * b if kind == "all-reduce" else b
            self.coll_n[kind] += 1
            self.bytes += b
            self.fused += b
            rec[2] += b
            self._track(outs)
            return
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            rec[1] += f
        op = func._opname
        if func.namespace in ("aten", "ditto") and op not in _NO_BYTES:
            b = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
            self.bytes += b
            rec[2] += b
            if op in _PRODUCTS:
                self.fused += 2 * (sum(t.numel() for t in ins)
                                   + sum(t.numel() for t in outs))
            elif op in _GATHERS:
                self.fused += 2 * sum(_bytes(t) for t in outs)
            elif op in _SCATTERS:
                self.fused += 2 * _bytes(ins[-1])
        self._track(outs)

    def _track(self, outs) -> None:
        """Add each new storage among ``outs`` to the live bytes, until
        it is freed."""
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self._refs:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs[key] = weakref.ref(st, self._freer(key, n))

    def _freer(self, key, n):
        def free(_):
            self.live -= n
            self._refs.pop(key, None)
        return free

    def report(self) -> CostReport:
        return CostReport(self.flops, self.bytes, self.fused,
                          sum(self.coll.values()), dict(self.coll),
                          dict(self.coll_n))


def count(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`OpCounter`)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c
