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

Each takes a ``pool`` (``dm/ranks.py``; None: the local pool, every
shard here).  ``dm`` is this rank's block of shards and every rank
calls with the same arguments: the drain runs on
the local ``[S_l, local_slots]`` view with a global "every shard within
budget" test each step, the lane resize's numpy runs over the gathered
client state and each rank keeps its block, a wipe runs on the rank that
holds the shard, and a rewarm gathers its candidates from every rank;
reports are global and equal on every rank.
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
from repro_torch.dm import ranks

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
    cap = torch.full(tuple(dm.state.capacity_blocks.shape),
                     new_global_capacity // n_shards, dtype=I64,
                     device=dm.state.capacity_blocks.device)
    return dm._replace(state=dm.state._replace(capacity_blocks=cap))


def set_tenant_budgets(dm, budgets, n_shards: int, pool=None):
    """Rewrite the per-tenant budgets (64B blocks, global units): one
    T-vector write per shard, split exactly (``split_tenant_budgets``).
    A tenant shrunk below its occupancy drains organically: its inserts
    are gated off and its own scoped evictions peel it back."""
    pool = ranks.or_local(pool, n_shards)
    split = split_tenant_budgets(budgets, n_shards)[pool.lo:pool.hi]
    tb = torch.as_tensor(split.astype(np.int64),
                         device=dm.state.tenant_budget.device)
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


def _arrivals(key_b, size_b, key_a, size_a) -> np.ndarray:
    """Slots live after a resize that were not live with the same key
    before: a key still live in the slot it held is home; only the
    other live slots are looked up."""
    live_b = (size_b != SIZE_EMPTY) & (size_b != SIZE_HISTORY)
    live_a = (size_a != SIZE_EMPTY) & (size_a != SIZE_HISTORY)
    return np.nonzero(live_a & ~(live_b & (key_a == key_b)))[0]


def _measured_migration_bytes(before: dict, after, pool=None) -> int:
    """Bytes that crossed a shard boundary: live keys present after the
    resize on a shard where they did not live before (real state delta).
    A hot key may live on several shards at once (a primary and its
    write-through replica mirrors), so a key's home is the set of shards
    it lived on, and a standing replica is no move.  The columns are
    gathered over the ranks only when some rank has an arrival."""
    S, value_words = before["shards"], before["value_words"]
    pool = ranks.or_local(pool, S)
    cols = [before["key"], before["size"], after.state.key.cpu().numpy(),
            after.state.size.cpu().numpy()]
    dev = after.state.key.device
    if not int(pool.sum_(torch.tensor(_arrivals(*cols).size, device=dev))):
        return 0
    cols = [pool.gather_ranks(torch.as_tensor(c, device=dev)).reshape(-1)
            .cpu().numpy() for c in cols]
    key_b, size_b, key_a, size_a = cols
    live_b = (size_b != SIZE_EMPTY) & (size_b != SIZE_HISTORY)
    cand = _arrivals(*cols)
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
                  max_steps: int = 256, pool=None
                  ) -> Tuple[object, ResizeReport]:
    """Online memory resize (budget in 64B blocks): grow = one capacity
    write per shard (zero migration); shrink = that write plus bounded
    priority-ordered drain steps until every shard's byte occupancy
    meets its new budget.  Returns the resized cache and a report of
    measured state deltas.  Raises RuntimeError if the drain cannot
    reach capacity in ``max_steps`` steps (a stuck drain is seen, not a
    silent overrun)."""
    pool = ranks.or_local(pool, dm.state.n_cached.shape[0])
    S = pool.n_shards
    assert new_global_capacity % S == 0
    before = _snapshot(dm, S, local_cfg.value_words)
    dm = _set_capacity_impl(dm, new_global_capacity, S)

    steps = 0
    drained = freed = dm.state.n_cached.new_zeros(())
    if drain:
        cap_per_shard = new_global_capacity // S
        while bool(pool.any_((dm.state.bytes_cached > cap_per_shard).any())):
            if steps >= max_steps:
                raise RuntimeError(
                    f"shrink drain did not reach capacity="
                    f"{new_global_capacity} blocks in {max_steps} steps "
                    f"(bytes_cached="
                    f"{int(pool.sum_(dm.state.bytes_cached.sum()))})")
            state, stats, n_ev, n_freed = _drain_step(
                local_cfg, batch_per_shard, dm.state, dm.stats)
            dm = dm._replace(state=state, stats=stats)
            drained = drained + n_ev.sum()
            freed = freed + n_freed.sum()
            steps += 1

    report = ResizeReport(
        migration_bytes=_measured_migration_bytes(before, dm, pool),
        drained_objects=int(pool.sum_(drained)),
        drained_bytes=int(pool.sum_(freed)) * 64, drain_steps=steps)
    return dm, report


def enforce_budget(local_cfg: CacheConfig, dm, *, batch_per_shard: int = 64,
                   max_steps: int = 8, pool=None) -> Tuple[object, int]:
    """Maintenance sweep: drain any shard over its byte budget, at most
    ``max_steps`` steps.  The batched access path tolerates transient
    occupancy drift (duplicate victims, hit-only steps, samples on empty
    slots at low live density), and after a deep shrink the sampler alone
    may not hold the line.  Returns (dm, drained)."""
    pool = ranks.or_local(pool, dm.state.n_cached.shape[0])
    drained = dm.state.n_cached.new_zeros(())
    for _ in range(max_steps):
        over = dm.state.bytes_cached > dm.state.capacity_blocks
        if not bool(pool.any_(over.any())):
            break
        state, stats, n_ev, _ = _drain_step(local_cfg, batch_per_shard,
                                            dm.state, dm.stats)
        dm = dm._replace(state=state, stats=stats)
        drained = drained + n_ev.sum()
    return dm, int(pool.sum_(drained))


# ----------------------------------------------------------------------
# Compute scale: client-lane width changes with state carry-over.
# ----------------------------------------------------------------------

def resize_lanes(local_cfg: CacheConfig, dm, new_lanes_per_shard: int, *,
                 seed: int = 1, pool=None) -> Tuple[object, ResizeReport]:
    """Change the client-lane count per shard without touching the pool.

    Surviving lanes carry their FC cache and penalty buffers over.
    Decommissioned lanes flush: buffered freq deltas land in the table
    (the shutdown FAA burst) and pending expert penalties fold into the
    global weights (one last lazy-weight-update RPC).  New lanes start
    from the current global weights with an empty FC cache.  The JAX
    package's numpy, on host copies (over ranks: of every rank's lanes
    and weights, gathered; each rank flushes into its own shards and
    keeps its block); the result goes back to the cache's device."""
    n_local = dm.state.n_cached.shape[0]
    pool = ranks.or_local(pool, n_local)
    S, lo = pool.n_shards, pool.lo
    old_lanes = dm.clients.fc_slot.shape[0] // n_local
    new_total = S * new_lanes_per_shard
    if new_lanes_per_shard == old_lanes:
        return dm, ResizeReport(0, 0, 0, 0)
    dev = dm.state.key.device
    before = _snapshot(dm, S, local_cfg.value_words)

    clients = ClientState(*[
        pool.gather_ranks(x).reshape((S * old_lanes,) + tuple(x.shape[1:]))
        for x in dm.clients])
    weights = pool.gather_shards(dm.state.weights)
    local_slots = local_cfg.n_slots
    per_shard = ClientState(*[
        x.cpu().numpy().reshape((S, old_lanes) + tuple(x.shape[1:]))
        for x in clients])

    freq = dm.state.freq.cpu().numpy().copy()
    weights = weights.cpu().numpy().copy()             # [S, E] / [S, T, E]
    keep = min(old_lanes, new_lanes_per_shard)

    if new_lanes_per_shard < old_lanes:
        # Decommission flush of lanes [keep:].  The penalty buffers are
        # [E] or [T, E] a lane; each expert row normalizes on axis -1.
        pen_total = np.zeros(per_shard.penalty_acc.shape[2:], np.float32)
        for s in range(S):
            pen_total += per_shard.penalty_acc[s, keep:].sum(axis=0)
        for s in range(n_local):
            fs = per_shard.fc_slot[lo + s, keep:].reshape(-1)
            fd = per_shard.fc_delta[lo + s, keep:].reshape(-1)
            ok = (fs >= 0) & (fs < local_slots)
            np.add.at(freq, s * local_slots + fs[ok], fd[ok])
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

    block = slice(lo * new_lanes_per_shard,
                  (lo + n_local) * new_lanes_per_shard)
    clients = ClientState(*[torch.from_numpy(x[block]).to(dev)
                            for x in merged])
    state = dm.state._replace(
        freq=torch.from_numpy(freq).to(dev),
        weights=torch.from_numpy(weights[lo:lo + n_local]).to(dev))
    dm = dm._replace(state=state, clients=clients)
    return dm, ResizeReport(
        migration_bytes=_measured_migration_bytes(before, dm, pool),
        drained_objects=0, drained_bytes=0, drain_steps=0)


_WIPED = ("key", "key_hash", "ptr", "insert_ts", "last_ts", "freq", "tenant",
          "size", "ext", "values")
_MOVED = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts", "freq",
          "ext", "values", "tenant")


def fail_wipe_shard(local_cfg: CacheConfig, dm, k: int, pool=None):
    """Ground-truth loss of shard k: its slot columns and occupancy
    scalars (``n_cached``, ``bytes_cached``, ``tenant_bytes``,
    ``hist_ctr``, ``gds_L``) are zeroed (size ``SIZE_EMPTY``); the clock
    and the expert weights survive (the replacement re-syncs them on
    join).  Every shard's ``l0_epoch`` advances, so no lane's near-cache
    copy outlives the wipe.  Copies of the columns, then fills of shard
    k's slice, on the rank that holds it."""
    n_local = dm.state.n_cached.shape[0]
    pool = ranks.or_local(pool, n_local)
    assert 0 <= k < pool.n_shards
    j = k - pool.lo
    ls = local_cfg.n_slots
    st = dm.state
    out = {}
    if 0 <= j < n_local:
        for name in _WIPED + ("n_cached", "bytes_cached", "tenant_bytes",
                              "hist_ctr", "gds_L"):
            out[name] = getattr(st, name).clone()
        for name in _WIPED:
            out[name][j * ls:(j + 1) * ls] = 0       # SIZE_EMPTY == 0
        for name in ("n_cached", "bytes_cached", "tenant_bytes", "hist_ctr",
                     "gds_L"):
            out[name][j] = 0
    out["l0_epoch"] = (st.l0_epoch + 1) & M32
    return dm._replace(state=st._replace(**out))


def _place(local_cfg: CacheConfig, c_size, c_ten, c_bkt, size_k: np.ndarray,
           room: int, t_room: np.ndarray) -> tuple:
    """The rewarm's serial placement on shard k, hottest candidate first:
    each into the first empty slot of its home bucket (``size_k``, shard
    k's sizes, written as it goes), within ``room`` blocks of k's byte
    capacity and ``t_room`` of each tenant's budget.  Returns (the
    candidates placed, their slots in k)."""
    A = local_cfg.assoc
    multi = local_cfg.n_tenants > 1
    t_room = t_room.copy()
    picked, slots = [], []
    for i in range(len(c_size)):
        sz = int(c_size[i])
        if sz > room:
            continue
        t = int(c_ten[i])
        if multi and sz > t_room[t]:
            continue
        base = int(c_bkt[i]) * A
        free = np.nonzero(size_k[base:base + A] == SIZE_EMPTY)[0]
        if free.size == 0:
            continue
        size_k[base + int(free[0])] = sz
        picked.append(i)
        slots.append(base + int(free[0]))
        room -= sz
        t_room[t] -= sz
    return np.asarray(picked, np.int64), np.asarray(slots, np.int64)


# The integer columns a rewarm candidate's row carries (then its values
# and the bits of its ext row).
_ROW_INTS = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts", "freq",
             "tenant")


def rewarm_shard(local_cfg: CacheConfig, dm, k: int, *,
                 max_objects: int = 512,
                 pool=None) -> Tuple[object, ResizeReport]:
    """Recovery drain: move the hottest survivor-held objects whose home
    bucket is on shard k back onto k (hottest first by frequency, within
    k's byte capacity and per-tenant budgets, each into the first empty
    slot of its home bucket, each move clearing the survivor's slot).

    The JAX package does this in numpy over the whole table.  Here each
    rank (one, on the local pool) picks on the device its own candidates
    (live, not on k, homed on k) and their hottest ``max_objects`` (the
    pool's hottest are among them) in slot order, with their rows; the
    rows are gathered in rank order, which is global slot order, and
    sorted stably by frequency, descending.  The rank that holds k
    places them on the host against its slot sizes and budgets (the
    serial placement) and broadcasts where each went; each source rank
    clears the slots it gave up and k's rank writes the moved rows with
    index writes."""
    pool = ranks.or_local(pool, dm.state.n_cached.shape[0])
    S, n_local, lo = pool.n_shards, pool.n_local, pool.lo
    assert 0 <= k < S
    ls, lb = local_cfg.n_slots, local_cfg.n_buckets
    st = dm.state
    dev = st.key.device
    base = lo * ls
    kh = hash_key(st.key)
    home = bucket_of(kh, lb * S) // lb
    slot = torch.arange(st.key.shape[0], device=dev) + base
    live = (st.size != SIZE_EMPTY) & (st.size != SIZE_HISTORY)
    cand = torch.nonzero(live & (slot // ls != k) & (home == k))[:, 0]
    top = torch.sort(-st.freq[cand], stable=True).indices[:max_objects]
    cand = cand[torch.sort(top).values]
    vw = local_cfg.value_words
    rows = torch.cat([
        torch.stack([cand + base, bucket_of(kh[cand], lb)]
                    + [getattr(st, f)[cand] for f in _ROW_INTS], dim=1),
        st.values[cand], st.ext[cand].view(torch.int32).to(I64)], dim=1)
    counts = pool.gather_ranks(torch.tensor(cand.numel(), device=dev)).tolist()
    if max(counts) == 0:
        return dm, ResizeReport(0, 0, 0, 0)
    padded = rows.new_zeros((max(counts), rows.shape[1]))
    padded[:rows.shape[0]] = rows
    got = pool.gather_ranks(padded)
    every = torch.cat([got[r, :n] for r, n in enumerate(counts)])
    every = every[torch.sort(-every[:, 2 + _ROW_INTS.index("freq")],
                             stable=True).indices[:max_objects]]
    col = {f: every[:, 2 + i] for i, f in enumerate(_ROW_INTS)}
    col["values"] = every[:, 2 + len(_ROW_INTS):2 + len(_ROW_INTS) + vw]
    col["ext"] = every[:, 2 + len(_ROW_INTS) + vw:].to(torch.int32).view(F32)

    owner = pool.owner(k)
    dst = torch.full((every.shape[0],), -1, dtype=I64, device=dev)
    if pool.rank == owner:
        j = k - lo
        picked, slots = _place(
            local_cfg, col["size"].cpu().numpy(),
            col["tenant"].cpu().numpy(), every[:, 1].cpu().numpy(),
            st.size[j * ls:(j + 1) * ls].cpu().numpy().copy(),
            int(st.capacity_blocks[j]) - int(st.bytes_cached[j]),
            (st.tenant_budget[j] - st.tenant_bytes[j]).cpu().numpy())
        dst[torch.as_tensor(picked, device=dev)] = torch.as_tensor(
            k * ls + slots, device=dev)
    dst = pool.broadcast(dst, owner)
    moved = torch.nonzero(dst >= 0)[:, 0]
    if moved.numel() == 0:
        return dm, ResizeReport(0, 0, 0, 0)
    src, dst = every[moved, 0], dst[moved]
    sz, ten = col["size"][moved], col["tenant"][moved]

    out = {}
    mine = (src >= base) & (src < base + n_local * ls)
    if bool(mine.any()):
        for name in ("key", "key_hash", "size", "ptr"):
            out[name] = getattr(st, name).clone()
            out[name][src[mine] - base] = 0      # SIZE_EMPTY == 0
    nc = st.n_cached.clone()
    bc = st.bytes_cached.clone()
    tb = st.tenant_bytes.clone()
    s_loc = src[mine] // ls - lo
    ones = torch.ones_like(s_loc)
    nc.index_add_(0, s_loc, -ones)
    bc.index_add_(0, s_loc, -sz[mine])
    tb.index_put_((s_loc, ten[mine]), -sz[mine], accumulate=True)
    if pool.rank == owner:
        for name in _MOVED:
            c = out.get(name, getattr(st, name).clone())
            c[dst - base] = col[name][moved]
            out[name] = c
        j = k - lo
        nc[j] += moved.numel()
        bc[j] += sz.sum()
        tb.index_put_((torch.full_like(ten, j), ten), sz, accumulate=True)
    out.update(n_cached=nc, bytes_cached=bc, tenant_bytes=tb,
               l0_epoch=(st.l0_epoch + 1) & M32)
    dm = dm._replace(state=st._replace(**out))
    sz = sz.cpu().numpy()
    return dm, ResizeReport(
        migration_bytes=int((sz * 64 + 4 * local_cfg.value_words).sum()),
        drained_objects=int(sz.size), drained_bytes=int(sz.sum()) * 64,
        drain_steps=1)
