"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), as
in ``repro/models/rglru.py``.

The temporal mixing is a diagonal linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
with input-dependent gates.  Prefill and training run it as an
associative scan over T (:func:`associative_scan`, the odd/even
recursion of ``jax.lax.associative_scan``: ~2 log2 T vectorised passes);
decode is the single-step recurrence with O(1) state.  The JAX package
runs it outside any Pallas kernel, so the port runs it as plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import softplus
from repro_torch.models.sharding import maybe_shard

_C = 8.0  # Griffin's fixed gate sharpness


def causal_conv1d(u: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Per-channel causal conv, width W. u: [B, T, D]; w: [W, D].

    Returns (out, new_state), the state being the last W-1 inputs
    (decode folds it in front).  The W terms are added one by one in the
    inputs' dtype, each sum rounded, as the JAX package's Python ``sum``
    does (in bf16 that is not an f32 accumulation)."""
    width = w.shape[0]
    if state is not None:
        dt = torch.promote_types(state.dtype, u.dtype)
        u_full = torch.cat([state.to(dt), u.to(dt)], dim=1)
    else:
        u_full = F.pad(u, (0, 0, width - 1, 0))
    t = u.shape[1]
    out = 0
    for i in range(width):
        out = out + u_full[:, i:i + t, :] * w[i][None, None, :]
    new_state = u_full[:, -(width - 1):, :]
    return out.to(u.dtype), new_state


def _gates(u, params):
    r = torch.sigmoid(u @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(u @ params["w_i"] + params["b_i"])
    # -8.0 * softplus(lam) stays in lam's dtype (a Python float is weak in
    # JAX as in torch); the product with r in f32 promotes it.
    log_a = -_C * softplus(params["lam"]) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i.float()


def _combine(x, y):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def associative_scan(elems, dim: int = 1):
    """Inclusive scan of ``_combine`` over ``dim``, in the odd/even
    recursion of ``jax.lax.associative_scan`` (the same pairs combined in
    the same order, so the f32 results stay within a few ulp of XLA's)."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):       # interleave: even at 0, 2, ...
        shape = list(ev.shape)
        shape[dim] = n
        full = ev.new_empty(shape)
        sl(full, 0, None, 2).copy_(ev)
        sl(full, 1, None, 2).copy_(od)
        out.append(full)
    return out


def rglru_scan(u: torch.Tensor, params, h0: torch.Tensor | None = None):
    """u: [B, T, D_rnn] -> (y [B, T, D_rnn], h_T f32)."""
    a, g = _gates(u, params)                     # [B, T, D] f32
    b = g * u.float()
    if h0 is not None:
        # Fold the carried state into the first step.
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = associative_scan([a, b], dim=1)
    return h.to(u.dtype), h[:, -1]


def rglru_step(u_t: torch.Tensor, params, h_prev: torch.Tensor):
    """Single decode step. u_t: [B, D_rnn], h_prev: [B, D_rnn] (f32)."""
    a, g = _gates(u_t[:, None, :], params)
    h = a[:, 0] * h_prev + g[:, 0] * u_t.float()
    return h.to(u_t.dtype), h


def rglru_block(x: torch.Tensor, params, cfg, *, conv_state=None, h0=None,
                return_state: bool = False):
    """Griffin recurrent block: gate branch * RG-LRU branch -> out proj.

    x: [B, T, d_model].  Decode passes T = 1 with (conv_state, h0)."""
    y = F.gelu(x @ params["w_y"], approximate="tanh")      # [B, T, D_rnn]
    u = maybe_shard(x @ params["w_x"], "dp", None, "model")
    u, conv_state_new = causal_conv1d(u, params["conv_w"], conv_state)
    if x.shape[1] == 1 and h0 is not None:
        h, h_last = rglru_step(u[:, 0], params, h0)
        h = h[:, None, :]
    else:
        h, h_last = rglru_scan(u, params, h0)
    out = (y * h) @ params["w_o"]
    if return_state:
        return out, (conv_state_new, h_last)
    return out
