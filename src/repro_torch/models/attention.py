"""Attention: GQA/MQA/MHA with causal and sliding-window masks, as in
``repro/models/attention.py``.

``full_attention`` and ``chunked_attention`` are the JAX package's two
plain strategies, kept as plain torch (the tests hold them against
JAX).  ``attention_block`` runs the causal case (``window == 0``) in
one of two ways, chosen by its ``plain`` argument:

* ``plain=False`` (prefill and serving): ``kernels.ops.flash_attention_op``
  at every T, the hand-written kernel for CUDA tensors and its plain
  version for CPU tensors.  Both of the JAX package's branches compute
  that same function.  The kernel is forward only.
* ``plain=True`` (training: ``forward`` with labels): the JAX package's
  own branches, ``full_attention`` up to 8192 tokens and
  ``chunked_attention`` above, which autograd differentiates.  The JAX
  training path reaches no Pallas kernel either.

A sliding window (``window > 0``, the ``attn_local`` blocks) always
takes the JAX package's own plain strategies, as JAX chooses them
(``full_attention`` up to 8192 tokens, ``chunked_attention`` above):
neither the Pallas flash kernel nor the port's has a window.

Decode (one new token against a KV cache) lives in ``serve/decode.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gqa_heads
from repro_torch.models.layers import rope
from repro_torch.models.sharding import current_mesh, maybe_shard

NEG_INF = -2.0e38


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> the view [B, S, Hkv, n_rep, D] (GQA head
    sharing): ``expand`` with stride 0 on the repeat axis, no copy.
    ``kernels.ref.gqa_heads`` flattens it to [B, S, Hkv*n_rep, D] (a
    copy) where a plain version needs the heads on one axis; the flash
    kernel reads the view as it is."""
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d)


def _mask(t_idx, s_idx, window: int):
    m = s_idx[None, :] <= t_idx[:, None]
    if window > 0:
        m &= s_idx[None, :] > (t_idx[:, None] - window)
    return m


def full_attention(q, k, v, *, window: int = 0, q_offset: int = 0):
    """q: [B, T, H, D]; k/v: [B, S, H, D] or their ``repeat_kv`` view."""
    k, v = gqa_heads(k), gqa_heads(v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    t_idx = torch.arange(q.shape[1], device=q.device) + q_offset
    s_idx = torch.arange(k.shape[1], device=q.device)
    scores = torch.where(_mask(t_idx, s_idx, window)[None, None], scores,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def chunked_attention(q, k, v, *, chunk: int = 1024, window: int = 0,
                      q_offset: int = 0):
    """Online-softmax loop over KV chunks: O(T*chunk) score memory."""
    k, v = gqa_heads(k), gqa_heads(v)
    b, t, h, d = q.shape
    s = k.shape[1]
    if s % chunk:
        raise ValueError(f"chunked_attention: {s} keys is not a multiple "
                         f"of chunk={chunk}")
    scale = d ** -0.5
    t_idx = torch.arange(t, device=q.device) + q_offset
    m_run = torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, s, chunk):
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s_idx = c0 + torch.arange(chunk, device=q.device)
        sc = torch.einsum("bthd,bshd->bhts", q, kci).float() * scale
        sc = torch.where(_mask(t_idx, s_idx, window)[None, None], sc,
                         NEG_INF)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        o_run = (o_run * corr[..., None]
                 + torch.einsum("bhts,bshd->bhtd", p.to(q.dtype),
                                vci).float())
        m_run = m_new
    out = (o_run / torch.clamp(l_run, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)  # [B, T, H, D]


def attention_block(x, params, cfg, positions, *, window: int = 0,
                    plain: bool = False):
    """Causal self-attention over x: [B, T, d_model], within the last
    ``window`` positions where ``window > 0``.  params: wq/wk/wv/wo.
    ``plain`` (or a window): the JAX package's plain strategies, else
    the flash op (see the module docstring).

    Under a mesh q is sharded on its heads (``maybe_shard``, as the JAX
    package); where the model axis does not split the KV heads, the GQA
    view is flattened to all H heads (a copy) so that q, k and v shard
    alike for the flash op's sharding rule."""
    b, t, _ = x.shape
    hd = cfg.hd
    q = maybe_shard((x @ params["wq"]).reshape(b, t, cfg.n_heads, hd),
                    "dp", None, "model", None)
    k = (x @ params["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if not (plain or window):
        mesh = current_mesh()
        if mesh is not None and "model" in (mesh.mesh_dim_names or ()) and (
                cfg.n_kv_heads % mesh["model"].size()):
            k, v = gqa_heads(k), gqa_heads(v)
        o = ops.flash_attention_op(q, k, v)
    elif t > 8192:
        o = chunked_attention(q, k, v, window=window)
    else:
        o = full_attention(q, k, v, window=window)
    return o.reshape(b, t, cfg.n_heads * hd) @ params["wo"]
