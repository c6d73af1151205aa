"""Pool resize and shard failure/recovery for the DM runtime (DESIGN.md
§8, §14): the parts the ``Cluster`` handle needs.

A torch port of ``repro/elastic/resize.py``'s capacity and tenant-budget
writes (one scalar or T-vector write per shard, no data movement), the
ground-truth shard wipe of a failure and the recovery rewarm.  Each
returns a new ``DMCache`` and leaves the one it was given as it was.
The shrink drain (``resize_memory``, ``enforce_budget``) and the lane
resize (``resize_lanes``) belong to the elastic runtime, ROADMAP Queue 1
item 14, and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import bucket_of, hash_key
from repro_torch.core.types import (SIZE_EMPTY, SIZE_HISTORY, CacheConfig,
                                    split_tenant_budgets)
from repro_torch.core.u32 import M32

I64 = torch.int64


class ResizeReport(NamedTuple):
    """Measured outcome of one resize event."""

    migration_bytes: int    # bytes that moved between shards (real delta)
    drained_objects: int    # objects evicted by the shrink drain (moved,
    #                         for a rewarm)
    drained_bytes: int      # payload bytes those objects held
    drain_steps: int        # batched drain rounds until at-capacity


def _item14(name: str):
    raise NotImplementedError(
        f"{name} (the shrink drain and the lane resize of the elastic "
        "runtime) is ROADMAP Queue 1 item 14, not yet ported")


def resize_memory(*args, **kwargs):
    """Online resize with the shrink drain: not yet ported (item 14)."""
    _item14("resize_memory")


def enforce_budget(*args, **kwargs):
    """The budget drain: not yet ported (item 14)."""
    _item14("enforce_budget")


def resize_lanes(*args, **kwargs):
    """The client-lane resize: not yet ported (item 14)."""
    _item14("resize_lanes")


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
