"""Mixture-of-Experts layer (top-k routing, capacity-dropped dispatch), as
in ``repro/models/moe.py``.

The JAX package runs this block outside any Pallas kernel, so the port
runs it as plain torch: the routing of :func:`moe_route`, an index
gather into the [E, cap, d] expert buffer, three batched expert
products and a weighted gather back to the tokens.  Its sharding
annotations (``maybe_shard``: the expert axis over the mesh, the
all-to-all) have no counterpart on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


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
    # of bounds); here they are filtered out before the indexed write.
    idx_buf = torch.full((e, cap), n, dtype=torch.int64, device=dev)
    idx_buf[eid[keep], pos[keep]] = torch.arange(n, device=dev)[keep]
    return Route(topv, topi, pos, keep, idx_buf)


def moe_block(x: torch.Tensor, params, cfg, *,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """x: [B, T, d]. params: router [d, E], w_gate/w_up [E, d, ff],
    w_down [E, ff, d]. Returns [B, T, d]."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * t
    xt = x.reshape(n_tok, d)
    gate_logits = (xt @ params["router"].to(xt.dtype)).float()
    r = moe_route(gate_logits, k, capacity_factor)
    cap = r.idx_buf.shape[1]

    occupied = r.idx_buf < n_tok * k
    tok_of_slot = torch.where(occupied, r.idx_buf // k, 0)
    buf = torch.where(occupied[..., None],
                      xt[tok_of_slot.reshape(-1)].reshape(e, cap, d), 0)
    # The expert FFNs: ``ecd,edf->ecf`` as batched products.
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    out = torch.bmm(h, params["w_down"])

    # Combine: each choice's expert output (zero where dropped), weighted.
    eid = r.topi.reshape(-1)
    slot_of = torch.where(r.keep, eid * cap + r.pos, e * cap)
    out_flat = torch.cat([out.reshape(e * cap, d),
                          out.new_zeros((1, d))])
    got = out_flat[slot_of]
    combined = torch.sum(got.reshape(n_tok, k, d)
                         * r.topv[..., None].to(got.dtype), dim=1)
    return combined.reshape(b, t, d)


def moe_aux_loss(gate_logits_mean: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss hook: zero, as in the JAX package."""
    return torch.zeros((), dtype=torch.float32,
                       device=gate_logits_mean.device)
