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

No counterpart on one card: ``zero_specs`` and ``_constrain``, the
ZeRO-1 sharding specs of the master and moments over a ``data`` mesh
axis (ROADMAP Queue 1 item 17's mesh work).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.model import ModelConfig, forward, params_from_numpy

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


def init_opt(params) -> OptState:
    """f32 master copies of ``params`` and zero moments, on their
    device."""
    master = tree_map(lambda x: x.detach().to(F32, copy=True), params)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), master,
                    tree_map(torch.zeros_like, master),
                    tree_map(torch.zeros_like, master))


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
    fma in f64, where the product is exact), with :func:`_cosf`."""
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


def adamw_update(opt: OptState, grads, cfg: AdamWConfig) -> OptState:
    """One AdamW step on the f32 master from ``grads`` (a tree as the
    params, any float dtype): global-norm clipping, bias correction,
    decoupled weight decay."""
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
    return OptState(step, _unflatten(opt.master, master),
                    _unflatten(opt.m, m), _unflatten(opt.v, v))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    n_microbatches: int = 1, remat: str = "full"):
    """The train step ``(params, opt, batch) -> (params, opt, loss)``.
    batch: {'tokens'|'embeds', 'labels'} with the global batch leading;
    with microbatches it is split on that dim and the gradients are
    accumulated in f32, in order, as JAX's scan does."""

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
            grads = [g.to(F32) for g in grads]
        else:
            mbs = {k: x.reshape((n_microbatches, -1) + x.shape[1:])
                   for k, x in batch.items()}
            grads = [torch.zeros(x.shape, dtype=F32, device=x.device)
                     for x in tree_leaves(params)]
            loss = _f32(0.0, grads[0].device)
            for i in range(n_microbatches):
                li, gi = loss_and_grads(params,
                                        {k: x[i] for k, x in mbs.items()})
                grads = [a + g.to(F32) for a, g in zip(grads, gi)]
                loss = loss + li
            n = _f32(n_microbatches, loss.device)
            grads = [g / n for g in grads]
            loss = loss / n
        opt = adamw_update(opt, _unflatten(params, grads), opt_cfg)
        dtype = tree_leaves(params)[0].dtype
        return tree_map(lambda mp: mp.to(dtype), opt.master), opt, loss

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
