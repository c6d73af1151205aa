"""Pool resize and shard failure/recovery for the DM runtime (DESIGN.md
§8, §14), a torch port of ``repro/elastic/resize.py``.

* **Memory scale.** Growing the pool is one capacity write per shard,
  zero bytes migrated (``_set_capacity_impl``).  Shrinking drains
  online: ``resize_memory`` writes the new capacity, then runs bounded
  batches of priority-ordered evictions (lowest priority first under the
  dominant expert, victims filed into the embedded history like any
  other eviction) until every shard's bytes are within it.  One drain
  step is one batched pass over all S shards, on the ``[S,
  local_slots]`` view of the global columns; its only host read is the
  loop's over-budget test, as in the JAX package.  ``enforce_budget`` is
  the same drain as a bounded maintenance sweep.
* **Compute scale.** ``resize_lanes`` decommissions lanes by flushing
  their buffered freq deltas into the table and folding their pending
  expert penalties into the global weights, and brings new lanes up with
  the current global weights and an empty FC cache.  It is the JAX
  package's host numpy, so the fold's f32 sums are numpy's; the result
  goes back to the cache's device.
* **Failure.** The ground-truth shard wipe of a failure and the recovery
  rewarm.

Each returns a new ``DMCache`` and leaves the one it was given as it
was; a resize also returns a ``ResizeReport`` of measured numbers:
migration bytes come from real state deltas (a live key appearing on a
shard it did not occupy before).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import priority as prio
from repro_torch.core.cache import _is_live, _xla_sum0
from repro_torch.core.hashing import bucket_of, hash_key
from repro_torch.core.types import (SIZE_EMPTY, SIZE_HISTORY, CacheConfig,
                                    ClientState, MDView, init_clients,
                                    split_tenant_budgets)
from repro_torch.core.u32 import M32

I64 = torch.int64
F32 = torch.float32


class ResizeReport(NamedTuple):
    """Measured outcome of one resize event."""

    migration_bytes: int    # bytes that moved between shards (real delta)
    drained_objects: int    # objects evicted by the shrink drain (moved,
    #                         for a rewarm)
    drained_bytes: int      # payload bytes those objects held
    drain_steps: int        # batched drain rounds until at-capacity


def set_capacity(dm, new_global_capacity: int, n_shards: int):
    """Deprecated: use ``Cluster.with_capacity(blocks)``."""
    from repro_torch.dm.sharded_cache import _deprecated
    _deprecated("set_capacity")
    return _set_capacity_impl(dm, new_global_capacity, n_shards)


def _set_capacity_impl(dm, new_global_capacity: int, n_shards: int):
    """The paper's elastic resize: one budget write per shard (64B
    blocks), no data movement.  A multi-tenant pool's per-tenant split is
    ``set_tenant_budgets``'s."""
    cap = torch.full((n_shards,), new_global_capacity // n_shards,
                     dtype=I64, device=dm.state.capacity_blocks.device)
    return dm._replace(state=dm.state._replace(capacity_blocks=cap))


def set_tenant_budgets(dm, budgets, n_shards: int):
    """Rewrite the per-tenant budgets (64B blocks, global units): one
    T-vector write per shard, split exactly (``split_tenant_budgets``).
    A tenant shrunk below its occupancy drains organically: its inserts
    are gated off and its own scoped evictions peel it back."""
    tb = torch.as_tensor(split_tenant_budgets(budgets, n_shards).astype(
        np.int64), device=dm.state.tenant_budget.device)
    return dm._replace(state=dm.state._replace(tenant_budget=tb))




# ----------------------------------------------------------------------
# Shrink drain: priority-ordered batched evictions, all shards at once.
# ----------------------------------------------------------------------

def _tenant_mean(w: torch.Tensor) -> torch.Tensor:
    """The mean of [T, ...] weight rows over T as XLA computes
    ``w.mean(axis=0)`` on the CPU: its reduce's order, then a multiply by
    the f32 reciprocal of T (its rewrite of a division by a constant)."""
    return _xla_sum0(w) * float(np.float32(1) / np.float32(w.shape[0]))


def _drain_step(local_cfg: CacheConfig, batch: int, state, stats):
    """One drain step of every shard: evict up to ``batch`` of its
    lowest-priority live objects, bounded by its byte deficit (victims
    peel off in priority order until the freed blocks cover it).  The
    shards are a leading axis, on [S, local_slots] views of the columns.
    Returns (state, stats, evicted [S], freed blocks [S])."""
    S = state.n_cached.shape[0]
    ls = local_cfg.n_slots
    dev = state.key.device
    batch = min(int(batch), ls)
    size = state.size.view(S, ls)
    deficit = torch.clamp(state.bytes_cached - state.capacity_blocks, min=0)

    live = _is_live(size)
    md = MDView(size=size.to(F32),
                insert_ts=state.insert_ts.view(S, ls).to(F32),
                last_ts=state.last_ts.view(S, ls).to(F32),
                freq=state.freq.view(S, ls).to(F32),
                ext=state.ext.view(S, ls, -1),
                clock=state.clock[:, None].to(F32),
                gds_L=state.gds_L[:, None],
                cost=torch.ones((S, ls), dtype=F32, device=dev))
    # Drain under the dominant expert, the one the weights trust most; a
    # per-tenant [T, E] row set votes as its tenant mean.  Each shard's
    # row of the [S, E, ls] priorities is one index.
    prios = torch.stack([prio.REGISTRY[n].priority(md).expand(S, ls)
                         for n in local_cfg.experts], dim=1)
    w = state.weights
    w_vec = w if w.dim() == 2 else _tenant_mean(w.transpose(0, 1))
    e = torch.argmax(w_vec, dim=1)                            # [S]
    pe = prios[torch.arange(S, device=dev), e]
    pe = torch.where(live, pe, float("inf"))
    order = torch.sort(pe, dim=1, stable=True).indices[:, :batch]
    # The shortest priority-ordered prefix whose summed sizes reach the
    # deficit, at most ``batch`` victims.
    live_o = torch.gather(live, 1, order)
    sz = torch.where(live_o, torch.gather(size, 1, order), 0)
    take = live_o & (torch.cumsum(sz, dim=1) - sz < deficit[:, None])

    # Victims enter the embedded history as sampled evictions do.
    write_hist = take & (local_cfg.n_experts > 1) & local_cfg.use_lwh
    hist_rank = torch.cumsum(write_hist.to(I64), dim=1) - 1
    hist_ids = (state.hist_ctr[:, None]
                + torch.where(write_hist, hist_rank, 0)) & M32
    n_hist = write_hist.sum(dim=1)
    bmap = ((1 << e) & M32)[:, None]
    freed = torch.where(take, sz, 0).sum(dim=1)

    # The slots of ``order`` are distinct, so the writes are one index
    # copy of the victims' new values and the other slots' own.
    idx = (order + torch.arange(S, device=dev)[:, None] * ls).reshape(-1)
    out = {}
    for name, new in (
            ("size", torch.where(write_hist, SIZE_HISTORY, SIZE_EMPTY)),
            ("ptr", torch.where(write_hist, hist_ids, 0)),
            ("insert_ts", bmap.expand(S, batch))):
        col = getattr(state, name)
        own = col[idx].view(S, batch)
        out[name] = col.clone().index_copy_(
            0, idx, torch.where(take, new, own).reshape(-1))

    n_evict = take.sum(dim=1)
    live_sz = torch.where(_is_live(out["size"]), out["size"], 0).view(S, ls)
    # Per-tenant bytes as T masked sums (a scatter-add of every slot onto
    # T counters a shard serializes on its atomics).
    mine = state.tenant.view(S, ls, 1) == torch.arange(
        state.tenant_bytes.shape[1], device=dev)
    state = state._replace(
        **out, n_cached=state.n_cached - n_evict,
        bytes_cached=live_sz.sum(dim=1),
        tenant_bytes=torch.where(mine, live_sz[..., None], 0).sum(dim=1),
        hist_ctr=(state.hist_ctr + n_hist) & M32,
        # Drain evictions bypass the step's bucket-version bumps, so a
        # draining shard flushes every lane's L0 through the epoch.
        l0_epoch=(state.l0_epoch + (n_evict > 0).to(I64)) & M32)
    # Cost accounting: a server-driven sweep, one sampling read per
    # victim batch, one CAS per victim, the history writes and one FAA.
    stats = stats._replace(
        rdma_read=stats.rdma_read + (n_evict > 0).to(I64),
        rdma_cas=stats.rdma_cas + n_evict,
        rdma_write=stats.rdma_write + n_hist,
        rdma_faa=stats.rdma_faa + (n_hist > 0).to(I64),
        evictions=stats.evictions + n_evict)
    return state, stats, n_evict, freed


def _snapshot(dm, n_shards: int, value_words: int) -> dict:
    return dict(key=dm.state.key.cpu().numpy().copy(),
                size=dm.state.size.cpu().numpy().copy(),
                shards=n_shards, value_words=value_words)


def _measured_migration_bytes(before: dict, after) -> int:
    """Bytes that crossed a shard boundary: live keys present after the
    resize on a shard where they did not live before (real state delta).
    A hot key may live on several shards at once (a primary and its
    write-through replica mirrors), so a key's home is the set of shards
    it lived on, and a standing replica is no move."""
    S, value_words = before["shards"], before["value_words"]
    key_b, size_b = before["key"], before["size"]
    key_a = after.state.key.cpu().numpy()
    size_a = after.state.size.cpu().numpy()
    live_b = (size_b != SIZE_EMPTY) & (size_b != SIZE_HISTORY)
    live_a = (size_a != SIZE_EMPTY) & (size_a != SIZE_HISTORY)
    # A key still live in the slot it held is home; only the other live
    # slots are looked up.
    cand = np.nonzero(live_a & ~(live_b & (key_a == key_b)))[0]
    if cand.size == 0:
        return 0
    local = key_b.shape[0] // S
    held = np.nonzero(live_b)[0]
    homes = key_b[held] * S + held // local                 # (key, shard)
    ka, sza = key_a[cand], size_a[cand]
    moved = np.isin(ka, key_b[held]) & ~np.isin(ka * S + cand // local,
                                                homes)
    return int((sza[moved] * 64 + 4 * value_words).sum())


def resize_memory(local_cfg: CacheConfig, dm, new_global_capacity: int, *,
                  drain: bool = True, batch_per_shard: int = 64,
                  max_steps: int = 256) -> Tuple[object, ResizeReport]:
    """Online memory resize (budget in 64B blocks): grow = one capacity
    write per shard (zero migration); shrink = that write plus bounded
    priority-ordered drain steps until every shard's byte occupancy
    meets its new budget.  Returns the resized cache and a report of
    measured state deltas.  Raises RuntimeError if the drain cannot
    reach capacity in ``max_steps`` steps (a stuck drain is seen, not a
    silent overrun)."""
    S = dm.state.n_cached.shape[0]
    assert new_global_capacity % S == 0
    before = _snapshot(dm, S, local_cfg.value_words)
    dm = _set_capacity_impl(dm, new_global_capacity, S)

    steps = 0
    drained = freed = dm.state.n_cached.new_zeros(())
    if drain:
        cap_per_shard = new_global_capacity // S
        while bool((dm.state.bytes_cached > cap_per_shard).any()):
            if steps >= max_steps:
                raise RuntimeError(
                    f"shrink drain did not reach capacity="
                    f"{new_global_capacity} blocks in {max_steps} steps "
                    f"(bytes_cached={int(dm.state.bytes_cached.sum())})")
            state, stats, n_ev, n_freed = _drain_step(
                local_cfg, batch_per_shard, dm.state, dm.stats)
            dm = dm._replace(state=state, stats=stats)
            drained = drained + n_ev.sum()
            freed = freed + n_freed.sum()
            steps += 1

    report = ResizeReport(
        migration_bytes=_measured_migration_bytes(before, dm),
        drained_objects=int(drained), drained_bytes=int(freed) * 64,
        drain_steps=steps)
    return dm, report


def enforce_budget(local_cfg: CacheConfig, dm, *, batch_per_shard: int = 64,
                   max_steps: int = 8) -> Tuple[object, int]:
    """Maintenance sweep: drain any shard over its byte budget, at most
    ``max_steps`` steps.  The batched access path tolerates transient
    occupancy drift (duplicate victims, hit-only steps, samples on empty
    slots at low live density), and after a deep shrink the sampler alone
    may not hold the line.  Returns (dm, drained)."""
    drained = dm.state.n_cached.new_zeros(())
    for _ in range(max_steps):
        if not bool((dm.state.bytes_cached > dm.state.capacity_blocks).any()):
            break
        state, stats, n_ev, _ = _drain_step(local_cfg, batch_per_shard,
                                            dm.state, dm.stats)
        dm = dm._replace(state=state, stats=stats)
        drained = drained + n_ev.sum()
    return dm, int(drained)


# ----------------------------------------------------------------------
# Compute scale: client-lane width changes with state carry-over.
# ----------------------------------------------------------------------

def resize_lanes(local_cfg: CacheConfig, dm, new_lanes_per_shard: int, *,
                 seed: int = 1) -> Tuple[object, ResizeReport]:
    """Change the client-lane count per shard without touching the pool.

    Surviving lanes carry their FC cache and penalty buffers over.
    Decommissioned lanes flush: buffered freq deltas land in the table
    (the shutdown FAA burst) and pending expert penalties fold into the
    global weights (one last lazy-weight-update RPC).  New lanes start
    from the current global weights with an empty FC cache.  The JAX
    package's numpy, on host copies; the result goes back to the cache's
    device."""
    S = dm.state.n_cached.shape[0]
    old_lanes = dm.clients.fc_slot.shape[0] // S
    new_total = S * new_lanes_per_shard
    if new_lanes_per_shard == old_lanes:
        return dm, ResizeReport(0, 0, 0, 0)
    dev = dm.state.key.device
    before = _snapshot(dm, S, local_cfg.value_words)

    local_slots = local_cfg.n_slots
    per_shard = ClientState(*[
        x.cpu().numpy().reshape((S, old_lanes) + tuple(x.shape[1:]))
        for x in dm.clients])

    freq = dm.state.freq.cpu().numpy().copy()
    weights = dm.state.weights.cpu().numpy().copy()     # [S, E] / [S, T, E]
    keep = min(old_lanes, new_lanes_per_shard)

    if new_lanes_per_shard < old_lanes:
        # Decommission flush of lanes [keep:].  The penalty buffers are
        # [E] or [T, E] a lane; each expert row normalizes on axis -1.
        pen_total = np.zeros(per_shard.penalty_acc.shape[2:], np.float32)
        for s in range(S):
            fs = per_shard.fc_slot[s, keep:].reshape(-1)
            fd = per_shard.fc_delta[s, keep:].reshape(-1)
            ok = (fs >= 0) & (fs < local_slots)
            np.add.at(freq, s * local_slots + fs[ok], fd[ok])
            pen_total += per_shard.penalty_acc[s, keep:].sum(axis=0)
        freq &= M32                                    # u32 wrap-around
        lam = np.float32(local_cfg.learning_rate)
        w = weights[0] * np.exp(-lam * pen_total)
        w = np.maximum(
            w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-30), 1e-4)
        weights = np.broadcast_to(w, weights.shape).copy()

    fresh = init_clients(local_cfg, new_total, seed, device="cpu")
    merged = []
    for old, new in zip(per_shard, fresh):
        out = new.numpy().reshape((S, new_lanes_per_shard)
                                  + tuple(new.shape[1:])).copy()
        out[:, :keep] = old[:, :keep]
        merged.append(out.reshape((new_total,) + out.shape[2:]))
    merged = ClientState(*merged)
    # New lanes adopt the (post-flush) global weights ([E] or [T, E]).
    wtail = per_shard.local_weights.shape[2:]
    lw = merged.local_weights.reshape((S, new_lanes_per_shard) + wtail)
    lw[:, keep:] = weights[:, None]

    clients = ClientState(*[torch.from_numpy(x).to(dev) for x in merged])
    state = dm.state._replace(freq=torch.from_numpy(freq).to(dev),
                              weights=torch.from_numpy(weights).to(dev))
    dm = dm._replace(state=state, clients=clients)
    return dm, ResizeReport(
        migration_bytes=_measured_migration_bytes(before, dm),
        drained_objects=0, drained_bytes=0, drain_steps=0)


_WIPED = ("key", "key_hash", "ptr", "insert_ts", "last_ts", "freq", "tenant",
          "size", "ext", "values")
_MOVED = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts", "freq",
          "ext", "values", "tenant")


def fail_wipe_shard(local_cfg: CacheConfig, dm, k: int):
    """Ground-truth loss of shard k: its slot columns and occupancy
    scalars (``n_cached``, ``bytes_cached``, ``tenant_bytes``,
    ``hist_ctr``, ``gds_L``) are zeroed (size ``SIZE_EMPTY``); the clock
    and the expert weights survive (the replacement re-syncs them on
    join).  Every shard's ``l0_epoch`` advances, so no lane's near-cache
    copy outlives the wipe.  Copies of the columns, then fills of shard
    k's slice."""
    S = dm.state.n_cached.shape[0]
    assert 0 <= k < S
    ls = local_cfg.n_slots
    st = dm.state
    out = {}
    for name in _WIPED + ("n_cached", "bytes_cached", "tenant_bytes",
                          "hist_ctr", "gds_L"):
        out[name] = getattr(st, name).clone()
    for name in _WIPED:
        out[name][k * ls:(k + 1) * ls] = 0       # SIZE_EMPTY == 0
    for name in ("n_cached", "bytes_cached", "tenant_bytes", "hist_ctr",
                 "gds_L"):
        out[name][k] = 0
    out["l0_epoch"] = (st.l0_epoch + 1) & M32
    return dm._replace(state=st._replace(**out))


def rewarm_shard(local_cfg: CacheConfig, dm, k: int, *,
                 max_objects: int = 512) -> Tuple[object, ResizeReport]:
    """Recovery drain: move the hottest survivor-held objects whose home
    bucket is on shard k back onto k (hottest first by frequency, within
    k's byte capacity and per-tenant budgets, each into the first empty
    slot of its home bucket, each move clearing the survivor's slot).

    The JAX package does this in numpy over the whole table.  Here the
    candidates (live, not on k, homed on k) are chosen on the card and
    sorted stably by frequency, descending; only those rows and shard
    k's slot sizes go to the host, where the serial placement runs; the
    moves are written back with index writes."""
    S = dm.state.n_cached.shape[0]
    assert 0 <= k < S
    ls, lb, A = local_cfg.n_slots, local_cfg.n_buckets, local_cfg.assoc
    st = dm.state
    dev = st.key.device
    kh = hash_key(st.key)
    home = bucket_of(kh, lb * S) // lb
    slot = torch.arange(st.key.shape[0], device=dev)
    live = (st.size != SIZE_EMPTY) & (st.size != SIZE_HISTORY)
    cand = torch.nonzero(live & (slot // ls != k) & (home == k))[:, 0]
    if cand.numel() == 0:
        return dm, ResizeReport(0, 0, 0, 0)
    order = torch.sort(-st.freq[cand], stable=True).indices
    cand = cand[order][:max_objects]
    c_size = st.size[cand].cpu().numpy()
    c_ten = st.tenant[cand].cpu().numpy()
    c_bkt = bucket_of(kh[cand], lb).cpu().numpy()
    cand_h = cand.cpu().numpy()
    size_k = st.size[k * ls:(k + 1) * ls].cpu().numpy().copy()

    nc = st.n_cached.cpu().numpy().copy()
    bc = st.bytes_cached.cpu().numpy().copy()
    tb = st.tenant_bytes.cpu().numpy().copy()
    tbud = st.tenant_budget.cpu().numpy()
    cap_k = int(st.capacity_blocks[k])
    multi = local_cfg.n_tenants > 1
    src, dst = [], []
    moved_bytes = freed_blocks = 0
    for i, s_idx in enumerate(cand_h):
        sz = int(c_size[i])
        if bc[k] + sz > cap_k:
            continue
        t = int(c_ten[i])
        if multi and tb[k, t] + sz > tbud[k, t]:
            continue
        base = int(c_bkt[i]) * A
        free = np.nonzero(size_k[base:base + A] == SIZE_EMPTY)[0]
        if free.size == 0:
            continue
        size_k[base + int(free[0])] = sz
        src.append(int(s_idx))
        dst.append(k * ls + base + int(free[0]))
        s_shard = int(s_idx) // ls
        nc[k] += 1
        nc[s_shard] -= 1
        bc[k] += sz
        bc[s_shard] -= sz
        tb[k, t] += sz
        tb[s_shard, t] -= sz
        freed_blocks += sz
        moved_bytes += sz * 64 + 4 * local_cfg.value_words
    if not src:
        return dm, ResizeReport(0, 0, 0, 0)

    src_t = torch.as_tensor(src, dtype=I64, device=dev)
    dst_t = torch.as_tensor(dst, dtype=I64, device=dev)
    out = {}
    for name in _MOVED:
        col = getattr(st, name).clone()
        col[dst_t] = col[src_t]
        out[name] = col
    for name in ("key", "key_hash", "size", "ptr"):
        out[name][src_t] = 0                     # SIZE_EMPTY == 0
    for name, host in (("n_cached", nc), ("bytes_cached", bc),
                       ("tenant_bytes", tb)):
        out[name] = torch.as_tensor(host.astype(np.int64), device=dev)
    # Moves between shards bump no bucket version: flush every lane's L0
    # through the epoch.
    out["l0_epoch"] = (st.l0_epoch + 1) & M32
    dm = dm._replace(state=st._replace(**out))
    return dm, ResizeReport(
        migration_bytes=moved_bytes, drained_objects=len(src),
        drained_bytes=freed_blocks * 64, drain_steps=1)
