"""Mixture-of-Experts layer (top-k routing, capacity-dropped dispatch), as
in ``repro/models/moe.py``.

The JAX package runs this block outside any Pallas kernel, so the port
runs it as plain torch: the routing of :func:`moe_route`, an index
gather into the [E, cap, d] expert buffer, three batched expert
products and a weighted gather back to the tokens.

Under a mesh the expert buffers shard as in the JAX package
(``maybe_shard``: the experts over the model axis, the capacity over the
data axes), so the expert products run on each device's experts.  The
routing (a stable sort, ``searchsorted``, an indexed write), the gather
into the buffer and the weighted gather back have no DTensor sharding
rules, so they run as explicit regions: the routing on every device's
full copy of the gate logits (``sharding.replicated``); the gather of
each device's slots of the buffer from all tokens (an all-gather of the
tokens); the gather back from each device's slots only, as partial sums
reduced over the mesh (a reduce-scatter over the data axes and an
all-reduce over the model axis).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (current_mesh, local_offsets,
                                         maybe_shard, replicated)


class Route(NamedTuple):
    topv: torch.Tensor      # f32 [N, k]: the renormalised top-k gates
    topi: torch.Tensor      # int64 [N, k]: their experts, best first
    pos: torch.Tensor       # int64 [N*k]: each choice's place in its expert
    keep: torch.Tensor      # bool [N*k]: pos < cap
    idx_buf: torch.Tensor   # int64 [E, cap]: the choice in each slot, N*k empty


def capacity(n_tok: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert: the JAX package's Python expression (``round``
    halves to even)."""
    return int(max(1, round(n_tok * k / e * capacity_factor)))


def moe_route(gate_logits: torch.Tensor, k: int,
              capacity_factor: float = 1.25) -> Route:
    """Route N tokens' f32 gate logits [N, E] to their top k experts.

    ``lax.top_k`` returns equal gates lowest expert first; ``torch.topk``
    promises no order among ties, so the top k come from a stable
    descending sort, which keeps index order among equal values (bf16
    logits tie often among 64 experts).  The order of ``topi`` decides
    each choice's place in its expert (a stable argsort of the flat
    expert ids, token-major), and so which choices the capacity drops."""
    n_tok, e = gate_logits.shape
    gates = torch.softmax(gate_logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)

    cap = capacity(n_tok, k, e, capacity_factor)
    n = n_tok * k
    dev = gate_logits.device
    eid = topi.reshape(-1)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    starts = torch.searchsorted(sorted_eid, torch.arange(e, device=dev),
                                right=False)
    pos_sorted = torch.arange(n, device=dev) - starts[sorted_eid]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    # XLA's drop-mode scatter discards the dropped choices (row E, out
    # of bounds); here they all write one spare slot past the buffer,
    # which is cut off (no shape depends on the data).
    flat = torch.full((e * cap + 1,), n, dtype=torch.int64, device=dev)
    flat.index_put_((torch.where(keep, eid * cap + pos, e * cap),),
                    torch.arange(n, device=dev))
    return Route(topv, topi, pos, keep, flat[:e * cap].reshape(e, cap))


def moe_block(x: torch.Tensor, params, cfg, *,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: [B, T, d]. params: router [d, E], w_gate/w_up [E, d, ff],
    w_down [E, ff, d]. Returns [B, T, d]."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * t
    xt = x.reshape(n_tok, d)
    gate_logits = (xt @ params["router"].to(xt.dtype)).float()
    r = replicated(moe_route, gate_logits, k, capacity_factor)
    idx_buf = maybe_shard(r.idx_buf, "model", "dp")
    if current_mesh() is None:
        buf = _dispatch(idx_buf, xt, k)
    else:
        buf = maybe_shard(_dispatch_sharded(idx_buf, xt, k),
                          "model", "dp", None)
    # The expert FFNs: ``ecd,edf->ecf`` as batched products.
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    out = maybe_shard(torch.bmm(h, params["w_down"]), "model", "dp", None)
    if current_mesh() is None:
        combined = _combine(out, r.topi, r.keep, r.pos, r.topv)
    else:
        combined = maybe_shard(_combine_sharded(out, r), "dp", None)
    return combined.reshape(b, t, d)


def _dispatch_sharded(idx_buf, xt, k: int):
    """:func:`_dispatch` of each device's slots (``idx_buf``'s shard)
    from all tokens (``xt`` gathered): the buffer with ``idx_buf``'s
    placements on its first two dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = idx_buf.device_mesh
    # Each device reads the tokens of its slots only: the gradient of its
    # copy is a partial sum over the mesh dims that shard the slots.
    x_full = xt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate()
                         for p in idx_buf.placements])
    local = _dispatch(idx_buf.to_local(), x_full, k)
    e, cap = idx_buf.shape
    return DTensor.from_local(local, mesh, idx_buf.placements,
                              run_check=False, shape=(e, cap, xt.shape[1]),
                              stride=(cap * xt.shape[1], xt.shape[1], 1))


def _combine_sharded(out, r: Route):
    """:func:`_combine` from each device's shard of ``out`` [E, cap, d]:
    the choices whose slot it holds, weighted and summed over the top k
    (one choice at a time), as partial sums over the mesh (``Partial``
    on every mesh dim that shards ``out``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = out.device_mesh
    rep = [Replicate()] * mesh.ndim
    (el, cl, d), (e0, c0, _) = local_offsets(out)
    o = out.to_local().reshape(el * cl, d)
    o = torch.cat([o, o.new_zeros((1, d))])
    topi, keep, pos = (x.redistribute(mesh, rep).to_local()
                       for x in (r.topi, r.keep, r.pos))
    pl = [Partial() if isinstance(x, Shard) else Replicate()
          for x in out.placements]
    # The gates' gradient: each device's choices only (a partial sum).
    topv = r.topv.redistribute(mesh, rep).to_local(grad_placements=pl)
    n_tok, k = topi.shape
    pos = pos.reshape(n_tok, k)
    keep = keep.reshape(n_tok, k)
    acc = None
    for j in range(k):
        e, p = topi[:, j] - e0, pos[:, j] - c0
        mine = keep[:, j] & (e >= 0) & (e < el) & (p >= 0) & (p < cl)
        slot = torch.where(mine, e * cl + p, el * cl)
        term = o[slot] * topv[:, j, None].to(o.dtype)
        acc = term if acc is None else acc + term
    return DTensor.from_local(acc, mesh, pl, run_check=False,
                              shape=(n_tok, d), stride=(d, 1))


def _dispatch(idx_buf, xt, k: int):
    """The [E, cap, d] expert buffer: each slot's token row, zero where
    the slot is empty."""
    e, cap = idx_buf.shape
    occupied = idx_buf < xt.shape[0] * k
    tok_of_slot = torch.where(occupied, idx_buf // k, 0)
    return torch.where(occupied[..., None],
                       xt[tok_of_slot.reshape(-1)].reshape(e, cap, -1), 0)


def _combine(out, topi, keep, pos, topv):
    """Each token's choices' expert outputs (zero where dropped),
    weighted by their gates and summed: [N, d]."""
    e, cap, d = out.shape
    n_tok, k = topi.shape
    slot_of = torch.where(keep, topi.reshape(-1) * cap + pos, e * cap)
    out_flat = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))])
    got = out_flat[slot_of]
    return torch.sum(got.reshape(n_tok, k, d)
                     * topv[..., None].to(got.dtype), dim=1)


def moe_aux_loss(gate_logits_mean: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss hook: zero, as in the JAX package."""
    return torch.zeros((), dtype=torch.float32,
                       device=gate_logits_mean.device)
