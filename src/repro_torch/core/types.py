"""Core state for the Ditto cache, as PyTorch tensors.

The layout is the JAX package's (``repro/core/types.py``): a flat
struct-of-arrays over ``n_slots = n_buckets * assoc`` holding each
slot's atomic field (key / hash / size / ptr) and its inline access
metadata, so sampling K objects is one contiguous read.

**u32 columns are int64.**  PyTorch has no CPU add, shift, mod or
compare for ``torch.uint32``, so every column the reference keeps as
u32 (keys, hashes, sizes, timestamps, counters, the history counter,
the clock, PRNG keys) is an ``int64`` tensor holding a value in
[0, 2^32), masked after each wrapping add or multiply
(``core/u32.py``).  i32 scalars and the ``OpStats`` counters are int64
as well; f32 columns stay f32.  Narrowing the storage to 4 bytes is
left for later work.

**The counters are int64 by design.**  The JAX package's are i32 when
x64 is off (i64 under x64), and its byte counters wrap past 2^31 on
long sized traces.  The port's stay right there: its op counters equal
JAX's exactly and its byte counters (``rdma_read_bytes``,
``rdma_write_bytes``, ``hit_bytes``, ``miss_bytes``) equal JAX's modulo
2^32 (``tests/test_torch_counters.py``).

``state_from_numpy`` / ``state_to_numpy`` (and the ``clients_*`` /
``stats_*`` / ``dm_*`` pairs) carry the JAX package's pytrees, as numpy arrays,
into this package's tensors on a given device and back, with the JAX
dtypes restored on the way out.  Every constructor here builds on the
card unless the caller names a device (``device="cpu"``), and raises
where there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng

# Slot states, stored in the `size` field: 0 = empty, 0xFF = history
# entry, anything else = live object size in 64B blocks.
SIZE_EMPTY = 0
SIZE_HISTORY = 0xFF

# Width of the per-slot extension metadata (LRU-K ring, LRFU CRF, LIRS).
EXT_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static configuration of one Ditto cache instance (field meanings
    as in the JAX package's ``CacheConfig``)."""

    n_buckets: int = 4096
    assoc: int = 8
    capacity: int = 16384
    capacity_blocks: int = 0
    n_tenants: int = 1
    tenant_budget_blocks: tuple = ()
    hist_len: int = 0
    n_samples: int = 5
    sample_window: int = 0
    experts: tuple = ("lru", "lfu")
    learning_rate: float = 0.1
    base_discount: float = 0.005
    sync_period: int = 100
    fc_size: int = 64
    fc_threshold: int = 10
    value_words: int = 2
    backend: str = "fused"              # "fused" (hand-written kernels on
                                        # the card) | "reference" (plain
                                        # torch); decision-equivalent
    use_sfht: bool = True
    use_lwh: bool = True
    use_lwu: bool = True
    use_fc: bool = True
    l0_entries: int = 0
    sanitize: bool = False

    @property
    def n_slots(self) -> int:
        return self.n_buckets * self.assoc

    @property
    def history_len(self) -> int:
        return self.hist_len if self.hist_len > 0 else self.capacity

    @property
    def budget_blocks(self) -> int:
        return self.capacity_blocks if self.capacity_blocks > 0 else self.capacity

    @property
    def n_experts(self) -> int:
        return len(self.experts)

    @property
    def tenant_budgets(self) -> tuple:
        if self.tenant_budget_blocks:
            return tuple(int(b) for b in self.tenant_budget_blocks)
        t = self.n_tenants
        base, rem = divmod(self.budget_blocks, t)
        return tuple(base + (1 if i < rem else 0) for i in range(t))

    @property
    def discount(self) -> float:
        return float(self.base_discount) ** (1.0 / float(self.capacity))

    def __post_init__(self):
        if self.n_slots < 2 * self.capacity:
            raise ValueError(
                f"n_slots={self.n_slots} must be >= 2*capacity={2*self.capacity}"
                " (live objects + embedded history entries)")
        if self.n_experts > 32:
            raise ValueError("expert bitmap is 32 bits wide")
        if self.n_tenants < 1:
            raise ValueError(f"n_tenants={self.n_tenants} must be >= 1")
        if self.tenant_budget_blocks and \
                len(self.tenant_budget_blocks) != self.n_tenants:
            raise ValueError(
                f"tenant_budget_blocks has {len(self.tenant_budget_blocks)} "
                f"entries for n_tenants={self.n_tenants}")
        if any(b <= 0 for b in self.tenant_budget_blocks):
            raise ValueError("tenant budgets must be positive block counts")
        if self.backend not in ("reference", "fused"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.l0_entries < 0:
            raise ValueError(f"l0_entries={self.l0_entries} must be >= 0")

    def split(self) -> tuple:
        return self, ExecConfig(backend=self.backend)


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """HOW to execute (backend, planner width), split from the WHAT of
    :class:`CacheConfig`."""

    backend: str = "fused"
    batch: int = 32
    plan: Optional[str] = "adaptive"
    route_factor: int = 4
    window: int = 0
    donate: Optional[bool] = None   # run the step in place on the caller's
    #                                 table, consuming its handle (None =
    #                                 on for a cache on the card, off on
    #                                 the CPU, as the JAX package's rule)

    def __post_init__(self):
        if self.backend not in ("reference", "fused"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.batch < 1:
            raise ValueError(f"batch={self.batch} must be >= 1")
        if self.plan not in (None, "adaptive", "strict", "lane"):
            raise ValueError(f"unknown plan mode {self.plan!r}")


def merge_exec_config(cfg: CacheConfig, exec_cfg: ExecConfig) -> CacheConfig:
    if cfg.backend == exec_cfg.backend:
        return cfg
    return dataclasses.replace(cfg, backend=exec_cfg.backend)


class CacheState(NamedTuple):
    key: torch.Tensor           # u32[n_slots]
    key_hash: torch.Tensor      # u32[n_slots]
    size: torch.Tensor          # u32[n_slots] SIZE_EMPTY / blocks / SIZE_HISTORY
    ptr: torch.Tensor           # u32[n_slots] history id
    insert_ts: torch.Tensor     # u32[n_slots] (expert bitmap in history)
    last_ts: torch.Tensor       # u32[n_slots]
    freq: torch.Tensor          # u32[n_slots]
    ext: torch.Tensor           # f32[n_slots, EXT_WIDTH]
    values: torch.Tensor        # u32[n_slots, value_words]
    n_cached: torch.Tensor      # i32[]
    bytes_cached: torch.Tensor  # i32[]
    hist_ctr: torch.Tensor      # u32[]
    clock: torch.Tensor         # u32[]
    weights: torch.Tensor       # f32[E]
    gds_L: torch.Tensor         # f32[]
    capacity_blocks: torch.Tensor  # i32[]
    tenant: torch.Tensor        # u32[n_slots]
    tenant_bytes: torch.Tensor  # i32[T]
    tenant_budget: torch.Tensor  # i32[T]
    bucket_ver: torch.Tensor    # u32[n_buckets]
    l0_epoch: torch.Tensor      # u32[]


class ClientState(NamedTuple):
    fc_slot: torch.Tensor       # i32[C, F] slot index, -1 = empty
    fc_delta: torch.Tensor      # u32[C, F]
    fc_ins: torch.Tensor        # u32[C, F]
    local_weights: torch.Tensor  # f32[C, E]
    penalty_acc: torch.Tensor   # f32[C, E]
    penalty_cnt: torch.Tensor   # i32[C]
    rng: torch.Tensor           # u32[C, 2] threefry keys
    l0_key: torch.Tensor        # u32[C, L0]
    l0_bkt: torch.Tensor        # i32[C, L0]
    l0_tok: torch.Tensor        # u32[C, L0]
    l0_sz: torch.Tensor         # u32[C, L0]
    l0_val: torch.Tensor        # u32[C, L0, value_words]
    l0_last: torch.Tensor       # u32[C, L0]
    l0_seen_epoch: torch.Tensor  # u32[C]


class OpStats(NamedTuple):
    rdma_read: torch.Tensor
    rdma_write: torch.Tensor
    rdma_cas: torch.Tensor
    rdma_faa: torch.Tensor
    rpc: torch.Tensor
    rdma_read_bytes: torch.Tensor
    rdma_write_bytes: torch.Tensor
    gets: torch.Tensor
    sets: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    hit_bytes: torch.Tensor
    miss_bytes: torch.Tensor
    regrets: torch.Tensor
    evictions: torch.Tensor
    bucket_evictions: torch.Tensor
    insert_drops: torch.Tensor
    route_drops: torch.Tensor
    replica_writes: torch.Tensor
    replica_drops: torch.Tensor
    fc_hits: torch.Tensor
    fc_flushes: torch.Tensor
    weight_syncs: torch.Tensor
    l0_hits: torch.Tensor
    l0_invalidations: torch.Tensor


class MDView(NamedTuple):
    """A gathered view of slot metadata handed to priority functions."""

    size: torch.Tensor
    insert_ts: torch.Tensor
    last_ts: torch.Tensor
    freq: torch.Tensor
    ext: torch.Tensor
    clock: torch.Tensor
    gds_L: torch.Tensor
    cost: torch.Tensor


def split_tenant_budgets(budgets, n_shards: int) -> np.ndarray:
    """Exact per-shard split of global tenant budgets: i32[n_shards, T]
    whose column sums equal the budgets (remainder blocks to the lowest
    shard ids), as the JAX package's ``split_tenant_budgets``."""
    out = np.zeros((n_shards, len(budgets)), np.int32)
    for t, b in enumerate(budgets):
        base, rem = divmod(int(b), n_shards)
        out[:, t] = base
        out[:rem, t] += 1
    return out


def _weight_shape(cfg: CacheConfig) -> tuple:
    if cfg.n_tenants > 1:
        return (cfg.n_tenants, cfg.n_experts)
    return (cfg.n_experts,)


def on_device(device, who: str) -> torch.device:
    """``device``, or the card when it is None; raises if that is the card
    and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is present; pass "
                           "device='cpu' to build on the CPU")
    return device


def _i64(shape, device, fill=0):
    return torch.full(shape, fill, dtype=torch.int64, device=device)


def init_cache(cfg: CacheConfig, device=None) -> CacheState:
    device = on_device(device, "init_cache")
    n = cfg.n_slots
    return CacheState(
        key=_i64((n,), device), key_hash=_i64((n,), device),
        size=_i64((n,), device), ptr=_i64((n,), device),
        insert_ts=_i64((n,), device), last_ts=_i64((n,), device),
        freq=_i64((n,), device),
        ext=torch.zeros((n, EXT_WIDTH), dtype=torch.float32, device=device),
        values=_i64((n, cfg.value_words), device),
        n_cached=_i64((), device), bytes_cached=_i64((), device),
        hist_ctr=_i64((), device), clock=_i64((), device, 1),
        weights=torch.full(_weight_shape(cfg), 1.0 / cfg.n_experts,
                           dtype=torch.float32, device=device),
        gds_L=torch.zeros((), dtype=torch.float32, device=device),
        capacity_blocks=_i64((), device, cfg.budget_blocks),
        tenant=_i64((n,), device),
        tenant_bytes=_i64((cfg.n_tenants,), device),
        tenant_budget=torch.tensor(cfg.tenant_budgets, dtype=torch.int64,
                                   device=device),
        bucket_ver=_i64((cfg.n_buckets,), device),
        l0_epoch=_i64((), device),
    )


def init_clients(cfg: CacheConfig, n_clients: int, seed: int = 0,
                 device=None) -> ClientState:
    device = on_device(device, "init_clients")
    f, e, l0 = cfg.fc_size, cfg.n_experts, cfg.l0_entries
    wshape = (n_clients,) + _weight_shape(cfg)
    cnt_shape = (n_clients, cfg.n_tenants) if cfg.n_tenants > 1 \
        else (n_clients,)
    return ClientState(
        fc_slot=_i64((n_clients, f), device, -1),
        fc_delta=_i64((n_clients, f), device),
        fc_ins=_i64((n_clients, f), device),
        local_weights=torch.full(wshape, 1.0 / e, dtype=torch.float32,
                                 device=device),
        penalty_acc=torch.zeros(wshape, dtype=torch.float32, device=device),
        penalty_cnt=_i64(cnt_shape, device),
        rng=prng.split(prng.PRNGKey(seed, device), n_clients),
        l0_key=_i64((n_clients, l0), device),
        l0_bkt=_i64((n_clients, l0), device),
        l0_tok=_i64((n_clients, l0), device),
        l0_sz=_i64((n_clients, l0), device),
        l0_val=_i64((n_clients, l0, cfg.value_words), device),
        l0_last=_i64((n_clients, l0), device),
        l0_seen_epoch=_i64((n_clients,), device),
    )


def init_stats(device=None) -> OpStats:
    device = on_device(device, "init_stats")
    return OpStats(*[_i64((), device) for _ in OpStats._fields])


def stats_add(a: OpStats, **kw) -> OpStats:
    """The counters ``kw`` names, each plus its value (a tensor, or a
    number taken as a counter of that value), in one ``_foreach_add``
    (one launch on the card, not one a counter)."""
    old = [getattr(a, k) for k in kw]
    new = torch._foreach_add(old, [
        v if isinstance(v, torch.Tensor) else torch.full_like(c, v)
        for c, v in zip(old, kw.values())])
    return a._replace(**dict(zip(kw, new)))


def stats_sum(stats: OpStats) -> OpStats:
    """Per-shard counter arrays reduced to scalars."""
    return OpStats(*[f.sum() for f in stats])


def stats_delta(new: OpStats, old: OpStats) -> OpStats:
    """The counters' difference between two snapshots (a window's)."""
    return OpStats(*[n - o for n, o in zip(new, old)])


def hit_ratio(stats: OpStats) -> float:
    """Hits over executed ops (``gets + sets``), as the JAX package's
    canonical ``hit_ratio``.  A host read: call it outside the step."""
    return float(stats.hits) / max(float(stats.gets + stats.sets), 1.0)


def byte_hit_ratio(stats: OpStats) -> float:
    """Bytes served from the cache over bytes requested.  The port's
    int64 counters do not wrap, so past 2^31 bytes this reads the true
    ratio where the JAX package's i32 counters wrap and its
    ``byte_hit_ratio`` reads 0.  A counter that is negative (one carried
    in from JAX after it wrapped) reads 0, as there.  A host read."""
    hit_b, miss_b = float(stats.hit_bytes), float(stats.miss_bytes)
    if hit_b < 0 or miss_b < 0:
        return 0.0
    return hit_b / max(hit_b + miss_b, 1.0)


# ---------------------------------------------------------------------------
# Carrying state across from the JAX package (numpy in, numpy out).
# ---------------------------------------------------------------------------

_U32, _I32, _F32 = np.uint32, np.int32, np.float32
_STATE_DTYPES = dict(
    key=_U32, key_hash=_U32, size=_U32, ptr=_U32, insert_ts=_U32,
    last_ts=_U32, freq=_U32, ext=_F32, values=_U32, n_cached=_I32,
    bytes_cached=_I32, hist_ctr=_U32, clock=_U32, weights=_F32, gds_L=_F32,
    capacity_blocks=_I32, tenant=_U32, tenant_bytes=_I32,
    tenant_budget=_I32, bucket_ver=_U32, l0_epoch=_U32)
_CLIENT_DTYPES = dict(
    fc_slot=_I32, fc_delta=_U32, fc_ins=_U32, local_weights=_F32,
    penalty_acc=_F32, penalty_cnt=_I32, rng=_U32, l0_key=_U32, l0_bkt=_I32,
    l0_tok=_U32, l0_sz=_U32, l0_val=_U32, l0_last=_U32, l0_seen_epoch=_U32)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "f":
        return torch.tensor(a.astype(np.float32), device=device)
    return torch.tensor(a.astype(np.int64), device=device)


def _from_numpy(cls, tree, device):
    device = on_device(device, f"{cls.__name__} from numpy")
    get = tree.__getitem__ if isinstance(tree, dict) else tree.__getattribute__
    return cls(*[_to_tensor(get(f), device) for f in cls._fields])


def _to_numpy(tree, dtypes) -> dict:
    return {f: getattr(tree, f).detach().cpu().numpy().astype(dtypes[f])
            for f in tree._fields}


def state_from_numpy(tree, device=None) -> CacheState:
    """Any object with the CacheState fields (the JAX pytree, or numpy
    arrays of it) -> a CacheState of tensors on ``device`` (default: the
    card)."""
    return _from_numpy(CacheState, tree, device)


def state_to_numpy(state: CacheState) -> dict:
    return _to_numpy(state, _STATE_DTYPES)


def clients_from_numpy(tree, device=None) -> ClientState:
    return _from_numpy(ClientState, tree, device)


def clients_to_numpy(clients: ClientState) -> dict:
    return _to_numpy(clients, _CLIENT_DTYPES)


def stats_from_numpy(tree, device=None) -> OpStats:
    return _from_numpy(OpStats, tree, device)


def stats_to_numpy(stats: OpStats) -> dict:
    return _to_numpy(stats, {f: np.int64 for f in OpStats._fields})


def dm_from_numpy(tree, device=None):
    """The JAX package's ``DMCache`` (or numpy arrays of its leaves, or a
    dict of ``state``/``clients``/``stats`` dicts) -> the port's
    ``DMCache``: the slot columns global, the per-shard scalars [S]."""
    from repro_torch.dm.sharded_cache import DMCache
    get = tree.__getitem__ if isinstance(tree, dict) else tree.__getattribute__
    return DMCache(state_from_numpy(get("state"), device),
                   clients_from_numpy(get("clients"), device),
                   stats_from_numpy(get("stats"), device))


def dm_to_numpy(dm) -> dict:
    """A port ``DMCache`` as numpy dicts, with the JAX dtypes."""
    return {"state": state_to_numpy(dm.state),
            "clients": clients_to_numpy(dm.clients),
            "stats": stats_to_numpy(dm.stats)}
