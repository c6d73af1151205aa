"""Shared neural building blocks, as in ``repro/models/layers.py``
(pure functions on tensors; bf16 activations on the main path)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    x = table[tokens]
    if scale:  # gemma-style sqrt(d) embedding scaling
        x = x * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=torch.float32)).to(x.dtype)
    return x


def logits_and_xent(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of x [B, T, d] against the vocab table [V, d]
    (tied or untied) at labels [B, T], as the JAX package's: the logits
    in x's dtype, then f32 for the max, the log-sum-exp and the target
    gather.  The padded vocab rows take part, as they do in JAX.  Its
    vocab sharding (``maybe_shard``) has no counterpart on one card."""
    logits = torch.einsum("btd,vd->btv", x, table).float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)
