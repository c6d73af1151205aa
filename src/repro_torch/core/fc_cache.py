"""Client-side frequency-counter (FC) cache (paper §4.2.2).

Write-combining for the stateful ``freq`` counter: each client buffers
per-slot frequency deltas locally and issues the remote atomic only when
an entry is evicted (threshold reached, or replaced as the oldest).
Torch mirrors of ``repro/core/fc_cache.py``; argmax/argmin run on int32
casts of boolean masks and keep the first index on ties, as jnp's do.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.types import CacheConfig, ClientState
from repro_torch.core.u32 import M32

_NEG_INF = float("-inf")


class FCEmit(NamedTuple):
    """Combined counter updates to apply to the remote table this step."""

    slot: torch.Tensor    # i64[C, 2] target slot (-1 = nothing)
    delta: torch.Tensor   # u32[C, 2] buffered delta to add
    n_faa: torch.Tensor   # i64[] issued remote atomics
    n_hit: torch.Tensor   # i64[] FC cache hits


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[c, idx[c]] for x [C, F] and idx [C]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def fc_access(cfg: CacheConfig, clients: ClientState, slot: torch.Tensor,
              clock: torch.Tensor) -> Tuple[ClientState, FCEmit]:
    """Route one freq increment per client through its FC cache.

    Args:
      slot: i64[C] table slot whose freq increments; -1 for no-op lanes.
    """
    active = slot >= 0

    if not cfg.use_fc:
        emit_slot = torch.stack([torch.where(active, slot, -1),
                                 torch.full_like(slot, -1)], dim=1)
        emit_delta = torch.stack([active.to(torch.int64),
                                  torch.zeros_like(slot)], dim=1)
        return clients, FCEmit(emit_slot, emit_delta, active.sum(),
                               torch.zeros_like(active.sum()))

    fc_slot, fc_delta, fc_ins = clients.fc_slot, clients.fc_delta, clients.fc_ins
    F = fc_slot.shape[1]
    cols = torch.arange(F, device=slot.device)

    match = (fc_slot == slot[:, None]) & active[:, None]        # [C, F]
    hit = match.any(dim=1)
    hit_idx = match.to(torch.int32).argmax(dim=1)
    one_hot_hit = match & (cols[None, :] == hit_idx[:, None])

    new_delta = (fc_delta + one_hot_hit.to(torch.int64)) & M32
    over = one_hot_hit & (new_delta >= cfg.fc_threshold)
    thr_flush = over.any(dim=1)
    thr_idx = over.to(torch.int32).argmax(dim=1)
    emit0_slot = torch.where(thr_flush, _take(fc_slot, thr_idx), -1)
    emit0_delta = torch.where(thr_flush, _take(new_delta, thr_idx), 0)

    miss = active & ~hit
    empty = fc_slot < 0
    age_key = torch.where(empty, _NEG_INF, fc_ins.to(torch.float32))
    victim_idx = age_key.argmin(dim=1)
    victim_occupied = ~_take(empty, victim_idx)
    ev_flush = miss & victim_occupied
    emit1_slot = torch.where(ev_flush, _take(fc_slot, victim_idx), -1)
    emit1_delta = torch.where(ev_flush, _take(new_delta, victim_idx), 0)

    install = miss[:, None] & (cols[None, :] == victim_idx[:, None])

    fc_slot = torch.where(over, -1, fc_slot)
    fc_delta = torch.where(over, 0, new_delta)
    fc_slot = torch.where(install, slot[:, None], fc_slot)
    fc_delta = torch.where(install, 1, fc_delta)
    fc_ins = torch.where(install, clock, fc_ins)

    emit = FCEmit(
        slot=torch.stack([emit0_slot, emit1_slot], dim=1),
        delta=torch.stack([emit0_delta, emit1_delta], dim=1),
        n_faa=thr_flush.sum() + ev_flush.sum(),
        n_hit=hit.sum(),
    )
    return clients._replace(fc_slot=fc_slot, fc_delta=fc_delta,
                            fc_ins=fc_ins), emit


def fc_access_group(cfg: CacheConfig, clients: ClientState,
                    slots: torch.Tensor, ts: torch.Tensor):
    """Route a whole [G, C] request group through the FC caches at once
    (the batched analogue of G sequential ``fc_access`` rounds; see the
    JAX package's docstring for the equivalence conditions).

    Args:
      slots: i64[G, C] table slot per round per lane; -1 = no-op.
      ts: u32[G] per-round logical timestamps.
    Returns:
      (clients, emit_slot i64[C, 2F+G], emit_delta u32[C, 2F+G],
       n_faa i64[], n_hit i64[]).
    """
    G, C = slots.shape
    sl = slots.T                                            # [C, G]
    active = sl >= 0

    if not cfg.use_fc:
        return (clients, torch.where(active, sl, -1),
                active.to(torch.int64), active.sum(),
                torch.zeros_like(active.sum()))

    fc_slot, fc_delta, fc_ins = clients.fc_slot, clients.fc_delta, clients.fc_ins
    F = fc_slot.shape[1]
    dev = slots.device
    rounds = torch.arange(G, device=dev)

    match = (fc_slot[:, None, :] == sl[:, :, None]) & active[:, :, None]
    fc_hit_r = match.any(dim=2)                             # [C, G]
    cnt = match.sum(dim=1)                                  # [C, F]
    new_delta = (fc_delta + cnt) & M32

    over = (new_delta >= cfg.fc_threshold) & (cnt > 0)
    flush_slot = torch.where(over, fc_slot, -1)
    flush_delta = torch.where(over, new_delta, 0)
    fc_slot1 = torch.where(over, -1, fc_slot)
    fc_delta1 = torch.where(over, 0, new_delta)

    miss_r = active & ~fc_hit_r                             # [C, G]
    same = ((sl[:, :, None] == sl[:, None, :]) & miss_r[:, :, None]
            & miss_r[:, None, :])                           # [C, G, G]
    earlier = same & (rounds[None, None, :] < rounds[None, :, None])
    first_occ = miss_r & ~earlier.any(dim=2)                # [C, G]
    mcount = same.sum(dim=2)                                # [C, G]
    mrank = torch.cumsum(first_occ.to(torch.int64), dim=1) - 1
    n_miss = first_occ.sum(dim=1)                           # [C]

    empty1 = fc_slot1 < 0
    key = torch.where(empty1, -1.0, fc_ins.to(torch.float32))  # [C, F]
    fidx = torch.arange(F, device=dev)
    better = ((key[:, None, :] < key[:, :, None])
              | ((key[:, None, :] == key[:, :, None])
                 & (fidx[None, None, :] < fidx[None, :, None])))
    vrank = better.sum(dim=2)                               # [C, F]
    installing = vrank < n_miss[:, None]
    ev_flush = installing & ~empty1
    evict_slot = torch.where(ev_flush, fc_slot1, -1)
    evict_delta = torch.where(ev_flush, fc_delta1, 0)

    n_install = torch.clamp(n_miss, max=F)
    overflow = first_occ & (mrank >= n_install[:, None])
    spill_slot = torch.where(overflow, sl, -1)
    spill_delta = torch.where(overflow, mcount, 0)

    sel = (first_occ[:, None, :] & installing[:, :, None]
           & (vrank[:, :, None] == mrank[:, None, :]))      # [C, F, G]
    pick = sel.to(torch.int32).argmax(dim=2)                # [C, F]
    got = sel.any(dim=2)
    inst_slot = torch.gather(sl, 1, pick)
    inst_delta = torch.gather(mcount, 1, pick)
    inst_ts = ts[pick]

    fc_slot2 = torch.where(got, inst_slot, fc_slot1)
    fc_delta2 = torch.where(got, inst_delta, fc_delta1)
    fc_ins2 = torch.where(got, inst_ts, fc_ins)

    n_hit = fc_hit_r.sum() + miss_r.sum() - first_occ.sum()
    n_faa = over.sum() + ev_flush.sum() + overflow.sum()
    emit_slot = torch.cat([flush_slot, evict_slot, spill_slot], dim=1)
    emit_delta = torch.cat([flush_delta, evict_delta, spill_delta], dim=1)
    clients = clients._replace(fc_slot=fc_slot2, fc_delta=fc_delta2,
                               fc_ins=fc_ins2)
    return clients, emit_slot, emit_delta, n_faa, n_hit
