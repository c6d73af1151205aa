"""Mesh-aware sharding helpers, as in ``repro/models/sharding.py``, on
``torch.distributed``'s ``DeviceMesh`` and DTensor placements.

The model code calls ``maybe_shard(x, *axes)`` where the JAX package
calls ``with_sharding_constraint``: under an active mesh (:func:`use_mesh`,
the counterpart of ``with mesh:``; the dry run, the one-card mesh step)
the tensor is redistributed to the placements the tokens name; without a
mesh it is returned as it is, so every single-device path runs
unchanged.

A spec is a :class:`P`, a tuple with one entry per tensor dim, as JAX's
``PartitionSpec``: ``None`` (replicated), a mesh axis name, or a tuple of
names (the dim sharded over all of them, the first the outermost).
:func:`placements` turns it into one placement per mesh dim.  DTensor
orders several mesh dims that shard one tensor dim by their order in the
mesh, so a tuple must name its axes in the mesh's order
(``('pod', 'data')`` on a (pod, data, model) mesh: pod-major, as JAX).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

_MESH = None         # the active DeviceMesh (use_mesh)
_DP_OVERRIDE = None  # set by pure-DP layouts: which axes carry the batch


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of names), compared as the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P


def current_mesh():
    """The active mesh, or None."""
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active one (``with mesh:`` in JAX) and let plain
    tensors meet DTensors as replicated ones (a constant table, the RoPE
    angles) while it is."""
    global _MESH
    from torch.distributed.tensor.experimental import implicit_replication
    _register_rules()
    prev, _MESH = _MESH, mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH = prev


_RULES = []


def _register_rules() -> None:
    """DTensor sharding rules for the ops the model runs that DTensor has
    none for: the flash op's (``kernels/library.py``) and the mLSTM's log
    sigmoid (``F.logsigmoid``: its forward, which also returns a buffer,
    and its backward), elementwise, so replicated or sharded on the batch
    (dim 0) as its input is."""
    if _RULES:
        return
    from repro_torch.kernels import library
    library.register_sharding_rules()
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_forward.default)
    def _fwd(x):
        return [([p, p], [p]) for p in (Replicate(), Shard(0))]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _bwd(grad, x, buffer):
        return [([p], [p, p, p]) for p in (Replicate(), Shard(0))]

    _RULES.append(True)


def local_offsets(dt) -> tuple:
    """(local shape, global offset) of this rank's shard of DTensor
    ``dt``, each a tuple over its dims; even ``Shard`` placements, nested
    in the mesh's order (the first mesh dim outermost)."""
    from torch.distributed.tensor import Shard
    size, off = list(dt.shape), [0] * dt.dim()
    coord = dt.device_mesh.get_coordinate()
    for m, p in enumerate(dt.placements):
        if isinstance(p, Shard):
            size[p.dim] //= dt.device_mesh.size(m)
            off[p.dim] += coord[m] * size[p.dim]
    return tuple(size), tuple(off)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return mesh.shape[axis_names(mesh).index(name)]


def set_dp_axes(axes):
    """Override which mesh axes the 'dp' token resolves to (pure-DP layout
    folds 'model' into the batch)."""
    global _DP_OVERRIDE
    _DP_OVERRIDE = axes


def batch_axes(mesh=None):
    """The data-parallel axes of the active mesh ('pod' folds into DP)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    names = axis_names(mesh)
    if _DP_OVERRIDE is not None:
        return tuple(a for a in _DP_OVERRIDE if a in names) or None
    return tuple(a for a in ("pod", "data") if a in names) or None


def resolve(spec, mesh) -> P:
    """``maybe_shard``'s reading of axis tokens on ``mesh``: 'dp' is every
    data axis, a token naming an axis the mesh lacks is dropped, and an
    axis already claimed by an earlier dim is dropped from later dims."""
    names = set(axis_names(mesh))
    used: set = set()
    out = []
    for s in spec:
        if s == "dp":
            kept = tuple(a for a in batch_axes(mesh) or () if a not in used)
        elif isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a in names and a not in used)
        elif s in names and s not in used:
            kept = (s,)
        else:
            kept = ()
        used.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def spec(*tokens, mesh=None) -> P:
    """Resolve axis tokens into a spec for the given mesh."""
    mesh = mesh or current_mesh()
    names = set(axis_names(mesh)) if mesh is not None else set()
    out = []
    for s in tokens:
        if s == "dp":
            out.append(batch_axes(mesh))
        elif isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a in names)
            out.append(kept or None)
        elif s is None or s in names:
            out.append(s)
        else:
            out.append(None)
    return P(*out)


def placements(p, mesh) -> tuple:
    """One placement per mesh dim for spec ``p`` (axes the mesh lacks are
    dropped): ``Shard(d)`` on each axis that dim d names, ``Replicate()``
    on the rest.  An axis of one device shards nothing, so its placement
    is ``Replicate()`` (the one-card mesh: every op stays local, where
    DTensor's view rules would refuse some reshapes of a dim it takes as
    sharded)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, s in enumerate(p):
        axes = [a for a in ((s,) if isinstance(s, str) else (s or ()))
                if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec {p}: the axes of dim {d} must follow "
                             f"the mesh's order {names}")
        for a in axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {p}: axis {a!r} shards two dims")
            out[names.index(a)] = Shard(d)
    return tuple(Replicate() if axis_size(mesh, a) == 1 else pl
                 for a, pl in zip(names, out))


def local_shape(shape, p, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under spec
    ``p`` (even shards: each sharded dim divides by its axes' sizes)."""
    out = list(shape)
    for d, s in enumerate(p):
        for a in ((s,) if isinstance(s, str) else (s or ())):
            if a in axis_names(mesh):
                n = axis_size(mesh, a)
                if out[d] % n:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"split over {a!r} ({n})")
                out[d] //= n
    return tuple(out)


def distribute(x: torch.Tensor, p, mesh):
    """``x`` as a DTensor with spec ``p`` on ``mesh``.  A fake or meta
    ``x`` (the dry run's stand-ins) gives a DTensor over a fresh local
    shard of its dtype and device, made without a collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch._subclasses.fake_tensor import is_fake
    pl = placements(p, mesh)
    if is_fake(x) or x.device.type == "meta":
        local = x.new_empty(local_shape(x.shape, p, mesh))
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=x.shape, stride=_strides(x.shape))
    return distribute_tensor(x, mesh, pl)


def _strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over a dict tree of tensors and its spec tree."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def maybe_shard(x, *tokens):
    """``with_sharding_constraint`` that is the identity without a mesh.

    Axis tokens: 'model' -> TP axis; 'dp' -> all data axes; None ->
    replicated; see :func:`resolve`.  Under a mesh a plain tensor is taken
    as replicated, and the result is a DTensor with the resolved
    placements (a redistribution: a collective where the placements
    change across devices).  Where a dim's axes do not divide it (a batch
    of one over 16 data devices), its trailing axes are dropped until
    they do: XLA pads such a shard, DTensor's views need even ones."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    p = P(*(_even(s, n, mesh) for s, n in zip(resolve(tokens, mesh),
                                              x.shape)))
    return x.redistribute(mesh, placements(p, mesh))


def _even(s, n: int, mesh):
    """Spec entry ``s`` less its trailing axes until they divide ``n``."""
    axes = list((s,) if isinstance(s, str) else (s or ()))
    while axes and n % math.prod(axis_size(mesh, a) for a in axes):
        axes.pop()
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def replicated(fn, *args):
    """``fn(*args)`` on every device's full copy: under a mesh each
    DTensor argument is gathered to a replicated one (``redistribute``,
    an all-gather where it is sharded) and passed as its local tensor,
    and each tensor ``fn`` returns (also in a tuple or NamedTuple) comes
    back as a replicated DTensor.  The region for ops without a DTensor
    sharding rule; without a mesh it is ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local()
               if isinstance(a, DTensor) else a for a in args))
    wrap = lambda t: (DTensor.from_local(t, mesh, rep, run_check=False)
                      if isinstance(t, torch.Tensor) else t)
    if isinstance(out, tuple):
        parts = [wrap(t) for t in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return wrap(out)


def batch_local(fn, batched, shared=()):
    """``fn(*batched, *shared)`` on each device's rows: under a mesh each
    ``batched`` tensor is placed as the first one's batch dim (dim 0) is
    (its other mesh dims replicated) and each ``shared`` one replicated,
    ``fn`` runs on the local tensors, and every tensor it returns (in
    nested tuples) comes back as a DTensor with that batch placement.
    For a loop that is independent across rows (the sLSTM's steps):
    one DTensor op a step would cost its sharding propagation each
    time.  Without a mesh it is ``fn(*batched, *shared)``."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*batched, *shared)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = batched[0]
    pl = tuple(p if p == Shard(0) else Replicate()
               for p in (lead.placements if isinstance(lead, DTensor)
                         else [Replicate()] * mesh.ndim))
    rep = [Replicate()] * mesh.ndim

    def local(t, placements, grad_placements=None):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    # A shared tensor's gradient from each device's rows is a partial sum
    # over the mesh dims that shard the rows.
    part = [Partial() if p == Shard(0) else Replicate() for p in pl]
    out = fn(*(local(t, pl) for t in batched),
             *(local(t, rep, part) for t in shared))

    def wrap(o):
        if isinstance(o, tuple):
            return tuple(wrap(x) for x in o)
        return DTensor.from_local(o, mesh, pl, run_check=False)
    return wrap(out)
