"""AdamW with microbatched gradient accumulation, as in
``repro/train/optimizer.py``.

Params, gradients and the optimizer's trees are the model's dict of
tensors (``models.init_params``); leaves go in the JAX package's order
(dict keys sorted), so the global norm sums them as JAX does.
``OptState`` is a ``NamedTuple(step, master, m, v)``, as JAX's, so that
``train/checkpoint.py`` writes the same keys (``['opt']/.master/...``).

The f32 scalars of the update (``b1 ** t``, the bias corrections, the
clip scale) are f32 tensors on the params' device, as JAX computes them:
a Python float meeting an f32 array stays f32 there, while Python
arithmetic would round in f64, and each division is by a tensor on the
data's device (a CUDA division by a host scalar multiplies by its
reciprocal).  The learning rate is computed on the host, as XLA
compiles it (:func:`lr_at`).  Each leaf's sum of squares is PyTorch's
reduction, not XLA's order, and XLA reassociates some of the update's
products, so the update agrees with JAX's to f32 rounding (the tests'
bound is 1e-5), not bit for bit.

Under a mesh (``models/sharding.use_mesh``) the trees are DTensors:
:func:`zero_specs` gives the ZeRO-1 specs of the master, the moments and
the accumulated gradients (each param spec with the ``data`` axis on a
divisible free dim), and ``_constrain`` holds a tree to its specs, as
the JAX package's; without a mesh both are the identity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.model import ModelConfig, forward, params_from_numpy
from repro_torch.models.sharding import (P, axis_names, axis_size,
                                         current_mesh, maybe_shard)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: Any           # i32 0-d tensor
    master: Any         # f32 tree
    m: Any              # f32 tree
    v: Any              # f32 tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dicts of tensors (the same keys in
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` from its leaves in :func:`tree_leaves`'
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


def zero_specs(param_specs, params_abstract, mesh=None):
    """Extend each param spec with the data axis on its first free dim
    that the axis divides (ZeRO-1 over ``data``); the specs as they are
    without a mesh or a ``data`` axis."""
    mesh = mesh or current_mesh()
    if mesh is None or "data" not in axis_names(mesh):
        return param_specs
    dsize = axis_size(mesh, "data")

    def extend(spec, leaf):
        parts = list(spec) + [None] * (leaf.dim() - len(spec))
        for i, (s, dim) in enumerate(zip(parts, leaf.shape)):
            if s is None and dim % dsize == 0 and dim >= dsize:
                parts[i] = "data"
                return P(*parts)
        return P(*parts)

    return tree_map(extend, param_specs, params_abstract)


def _constrain(tree, specs):
    """Each leaf held to its spec under the active mesh (a
    redistribution); the tree as it is without a mesh or specs."""
    if current_mesh() is None or specs is None:
        return tree
    return tree_map(lambda x, s: maybe_shard(x, *s), tree, specs)


def init_opt(params, zspecs=None) -> OptState:
    """f32 master copies of ``params`` and zero moments, on their
    device; under a mesh held to ``zspecs``."""
    master = tree_map(lambda x: x.detach().to(F32, copy=True), params)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    _constrain(master, zspecs),
                    _constrain(tree_map(torch.zeros_like, master), zspecs),
                    _constrain(tree_map(torch.zeros_like, master), zspecs))


@functools.cache
def _libm():
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib


def _cosf(x: np.ndarray) -> np.ndarray:
    """The C library's ``cosf`` of each f32 in ``x``: XLA's CPU cosine
    is that function (equal on 200,001 arguments in [0, pi]), and a
    cosine one ulp apart moves the rate by several near the end of the
    decay, where ``1 + cos`` cancels."""
    cosf = _libm().cosf
    return np.array([cosf(v) for v in x.reshape(-1).tolist()],
                    np.float32).reshape(x.shape)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``, at ``step``
    (an f32 tensor of any shape, on any device; the rate comes back on
    it).  Computed on the host, as a scheduler's scalar, in f32 as XLA
    compiles the JAX package's ``lr_at`` in a train step: a division by
    a constant as a multiply by its f32 reciprocal, and
    ``lr * warm * (min_frac + (1 - min_frac) * 0.5 * (1 + cos))`` as
    ``(warm * lr) * fma(1 + cos, 0.5 * (1 - min_frac), min_frac)`` (the
    fma in f64, where the product is exact), with :func:`_cosf`.  A
    fake or meta step (the dry run's: it has no value to take to the
    host) gets the same expression in torch's f32 ops on its device."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(step) or step.device.type == "meta":
        return _lr_traced(cfg, step)
    f32 = np.float32
    s = step.detach().cpu().numpy().astype(f32)
    warm = np.minimum(s * (f32(1) / f32(max(cfg.warmup_steps, 1))), f32(1))
    prog = np.clip((s - f32(cfg.warmup_steps))
                   * (f32(1) / f32(max(cfg.total_steps - cfg.warmup_steps,
                                       1))), f32(0), f32(1))
    cos = _cosf(prog * f32(np.pi))
    half_range = np.float64(f32(0.5) * f32(1 - cfg.min_lr_frac))
    frac = ((cos + f32(1)) * half_range
            + np.float64(f32(cfg.min_lr_frac))).astype(f32)
    return torch.from_numpy(np.asarray((warm * f32(cfg.lr)) * frac, f32)
                            ).to(step.device)


def _lr_traced(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """:func:`lr_at`'s expression in torch's f32 ops, for a step with no
    value (the dry run); its numbers are not held to XLA's."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def adamw_update(opt: OptState, grads, cfg: AdamWConfig,
                 zspecs=None) -> OptState:
    """One AdamW step on the f32 master from ``grads`` (a tree as the
    params, any float dtype): global-norm clipping, bias correction,
    decoupled weight decay; under a mesh the new trees held to
    ``zspecs``."""
    step = opt.step + 1
    dev = step.device
    g32 = tree_map(lambda g: g.to(F32), grads)
    gn2 = _f32(0.0, dev)
    for g in tree_leaves(g32):
        gn2 = gn2 + torch.sum(torch.square(g))
    gn = torch.sqrt(gn2)
    scale = torch.clamp(_f32(cfg.grad_clip, dev)
                        / torch.clamp(gn, min=1e-12), max=1.0)
    t = step.to(F32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), t)
    lr = lr_at(cfg, t)

    def upd(g, m, v, p):
        g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        return m, v, p - lr * u

    out = [upd(*x) for x in zip(tree_leaves(g32), tree_leaves(opt.m),
                                tree_leaves(opt.v), tree_leaves(opt.master))]
    m, v, master = ([o[i] for o in out] for i in range(3))
    return OptState(step, _constrain(_unflatten(opt.master, master), zspecs),
                    _constrain(_unflatten(opt.m, m), zspecs),
                    _constrain(_unflatten(opt.v, v), zspecs))


def _microbatches(x, n: int):
    """x [B, ...] as [n, B / n, ...], microbatch i the rows [i B / n,
    (i + 1) B / n), as JAX splits it.  Under a mesh the batch is
    gathered first (DTensor cannot split a sharded dim) and each
    microbatch's rows are then sharded over the data axes."""
    rest = [None] * (x.dim() - 1)
    x = maybe_shard(x, None, *rest).reshape((n, -1) + tuple(x.shape[1:]))
    return maybe_shard(x, None, "dp", *rest)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    n_microbatches: int = 1, remat: str = "full",
                    param_specs=None, zspecs=None):
    """The train step ``(params, opt, batch) -> (params, opt, loss)``.
    batch: {'tokens'|'embeds', 'labels'} with the global batch leading;
    with microbatches it is split on that dim and the gradients are
    accumulated in f32, in order, as JAX's scan does.  Under a mesh the
    gradients and the optimizer's trees are held to ``zspecs`` and the
    new params to ``param_specs``, as the JAX package's step does."""
    constrain = lambda leaves, specs: tree_leaves(
        _constrain(_unflatten(specs, leaves), specs)) if specs else leaves

    def loss_and_grads(params, mb):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        p = _unflatten(params, leaves)
        loss = forward(p, cfg, tokens=mb.get("tokens"),
                       embeds=mb.get("embeds"), labels=mb["labels"],
                       remat=remat)
        # A leaf the loss never reads (the token table of a stub-frontend
        # arch with its own unembedding) has a zero gradient, as in JAX.
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def train_step(params, opt: OptState, batch):
        if n_microbatches == 1:
            loss, grads = loss_and_grads(params, batch)
            grads = constrain([g.to(F32) for g in grads], zspecs)
        else:
            mbs = {k: _microbatches(x, n_microbatches)
                   for k, x in batch.items()}
            grads = constrain([torch.zeros_like(x, dtype=F32)
                               for x in tree_leaves(params)], zspecs)
            loss = _f32(0.0, grads[0].device)
            for i in range(n_microbatches):
                li, gi = loss_and_grads(params,
                                        {k: x[i] for k, x in mbs.items()})
                grads = constrain([a + g.to(F32) for a, g in zip(grads, gi)],
                                  zspecs)
                loss = loss + li
            n = _f32(n_microbatches, loss.device)
            grads = [g / n for g in grads]
            loss = loss / n
        opt = adamw_update(opt, _unflatten(params, grads), opt_cfg, zspecs)
        dtype = tree_leaves(params)[0].dtype
        new = tree_map(lambda mp: mp.to(dtype), opt.master)
        return _constrain(new, param_specs), opt, loss

    return train_step


def opt_from_numpy(opt, device) -> OptState:
    """The JAX package's ``OptState`` (or any (step, master, m, v) of
    numpy arrays) as this package's, on ``device``."""
    step, master, m, v = opt
    return OptState(torch.tensor(np.asarray(step), dtype=torch.int32,
                                 device=device),
                    *(params_from_numpy(t, device) for t in (master, m, v)))


def opt_to_numpy(opt: OptState) -> OptState:
    """The inverse of :func:`opt_from_numpy`: an ``OptState`` of numpy
    arrays on the host (``repro.train.OptState(*it)`` rebuilds JAX's)."""
    return OptState(opt.step.detach().cpu().numpy(),
                    *(tree_map(lambda x: x.detach().cpu().numpy(), t)
                      for t in (opt.master, opt.m, opt.v)))
