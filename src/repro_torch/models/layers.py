"""Shared neural building blocks, as in ``repro/models/layers.py``
(pure functions on tensors; bf16 activations on the main path)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (current_mesh, local_offsets,
                                         maybe_shard)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the ``1 + scale`` form; the inner math in f32."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm, the inner math in f32; the variance is the mean of
    squared deviations (``jnp.var``)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``, op by op:
    ``max(x, 0) + log1p(exp(-|x|))``, each op rounded in x's dtype.  In
    bf16 this gives JAX's bits; ``F.softplus`` (one rounding,
    ``log1p(exp(x))`` below its threshold of 20) differs from it in about
    one bf16 value of ten."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings, half-split, f32 angles.  x: [B, T, H, D],
    positions: [B, T]."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w [d, f] (the JAX layout: no transpose)."""
    return x @ w


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    g = dense(x, w_gate)
    act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
    return dense(act * dense(x, w_up), w_down)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    """The table's rows at ``tokens``; under a mesh on each device's
    vocab shard (:func:`_embed_sharded`)."""
    x = table[tokens] if current_mesh() is None else _embed_sharded(
        tokens, table)
    if scale:  # gemma-style sqrt(d) embedding scaling
        x = x * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=torch.float32)).to(x.dtype)
    return x


def _embed_sharded(tokens, table):
    """The vocab-parallel lookup: each device gathers the tokens its
    shard of the table holds (zero rows for the rest), as partial sums
    over the axes that shard the vocab; the tokens keep their batch
    placement.  DTensor's own rule for the gather refuses a batch sharded
    over two mesh axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = current_mesh()
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    (vl, d), (v0, _) = local_offsets(table)
    if isinstance(tokens, DTensor):
        tok_pl, tok = tokens.placements, tokens.to_local()
    else:
        tok_pl, tok = [Replicate()] * mesh.ndim, tokens
    idx = tok.long() - v0
    ok = (idx >= 0) & (idx < vl)
    # The local table's gradient holds this device's tokens' rows only:
    # a partial sum over the mesh dims that shard the tokens.
    grad_pl = [p if isinstance(p, Shard) else
               Partial() if isinstance(t, Shard) else Replicate()
               for p, t in zip(table.placements, tok_pl)]
    rows = table.to_local(grad_placements=grad_pl)[torch.where(ok, idx, 0)]
    rows = torch.where(ok[..., None], rows, 0)
    pl = [Partial() if isinstance(t, Shard) else p
          for t, p in zip(table.placements, tok_pl)]
    shape = tuple(tokens.shape) + (d,)
    return DTensor.from_local(rows, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(math.prod(shape[i + 1:])
                                           for i in range(len(shape))))


def logits_and_xent(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of x [B, T, d] against the vocab table [V, d]
    (tied or untied) at labels [B, T], as the JAX package's: the logits
    in x's dtype, then f32 for the max, the log-sum-exp and the target
    gather.  The padded vocab rows take part, as they do in JAX.  Under a
    mesh the logits shard on the vocab (``maybe_shard``), so the
    reductions run over the sharded axis, and the target logit is
    :func:`_target_sharded`'s (DTensor's gather over a sharded vocab
    fails)."""
    logits = torch.einsum("btd,vd->btv", x, table).float()
    logits = maybe_shard(logits, "dp", None, "model")
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    if current_mesh() is None:
        tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        tgt = _target_sharded(logits, labels)
    return torch.mean(lse - tgt)


def _target_sharded(logits, labels):
    """Each row's logit at its label, from each device's shard of the
    logits [B, T, V] as it lies: a masked sum over its vocab columns (the
    label's column, or nothing), as partial sums over the mesh dims that
    shard the vocab.  The labels are placed as the logits' rows; no
    [B, T, V] mask is built on more than a device's own shard (DTensor's
    broadcast of a mask against labels sharded over two mesh axes
    gathers the rows in the backward)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    (bl, tl, vl), (_, _, v0) = local_offsets(logits)
    row_pl = [p if p in (Shard(0), Shard(1)) else Replicate()
              for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, row_pl).to_local().long() - v0
    cols = torch.arange(vl, device=lab.device)
    tgt = torch.where(cols == lab[..., None], logits.to_local(),
                      0.0).sum(dim=-1)
    pl = [Partial() if p == Shard(2) else q
          for p, q in zip(logits.placements, row_pl)]
    shape = tuple(logits.shape[:2])
    return DTensor.from_local(tgt, mesh, pl, run_check=False, shape=shape,
                              stride=(shape[1], 1))
