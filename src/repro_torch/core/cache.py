"""The Ditto cache step: the client-centric caching framework plus
distributed adaptive caching, as one batched function on tensors.

A torch port of ``repro/core/cache.py``.  One step applies a [G, C]
group of client operations (G rounds x C lanes) against the step-entry
snapshot of the table: bucket probe, hit-metadata update with the
frequency-counter (FC) cache flush, regret collection and the expert
weights, read-through inserts, the sampled ranked eviction, then the
apply and the ``OpStats`` metering.  Round r runs at logical time
``clock + r``.  ``backend="fused"`` routes the probe, the metadata
update, the eviction decision (with each request's threefry draw of its
sample offset and expert choice) and the apply's writes through
``kernels/ops.py`` (the CUDA kernels on the card);
``backend="reference"`` computes them in plain torch.  Both make the
same decisions.

Port notes:

* u32 columns are int64 (``core/types.py``); wrapping adds are masked.
* The step writes the table in place (:func:`access_group_`), as XLA
  does JAX's ``.at[].set(mode="drop")`` updates: it reads the step-entry
  table first, then writes only the slots it touches, in the JAX
  package's order.  :func:`access_group` is the functional form (copies
  of the written columns, then the in-place step).
* The step issues no host sync and no upload: no ``.item()``, no
  boolean-mask indexing, no Python branch on a tensor value, no tensor
  made from host data.  That lets the trace drivers replay a step as a
  CUDA graph on the card (``_scan``).
* Duplicate-index writes resolve explicitly: SET payloads and sizes are
  last-writer-wins (highest request position per slot, from a stable
  sort of the step's indices); every other scatter target is unique, or
  its duplicates write equal values.
* Float sums follow XLA's CPU order, f32 adds one at a time: the
  per-lane penalties in request order (its scatter-add), the synced
  penalty total over lanes in its reduce's row ranges, nested past
  1,024 lanes (``_xla_sum0``),
  the expert cdf and the normalising sums over E in index order
  (``_seqsum`` and its kin); no float atomics, so the step is
  deterministic on the card.
* ``n_tenants > 1`` partitions the pool (DESIGN.md §11): per-tenant
  [T, E] expert weights, tenant-scoped eviction quotas (the draw kernel
  reads each op's (lane, tenant) cdf row and filters its sample), and the
  budget gate.  ``tenant_bytes`` moves by the change at the slots the
  step writes (the JAX package recomputes it from the whole table; the
  two agree, integers being exact in any order).
* ``l0_entries > 0`` runs the per-lane L0 near-cache (DESIGN.md §15) in
  plain torch on both backends: the probe masks an L0-served GET to a
  padded no-op before the remote path, and the bucket-version bump and
  the one-per-lane fill follow the apply.
* ``shadow`` marks the DM layer's write-through replica mirrors
  (``dm/sharded_cache.py``): they execute in full and move the RDMA
  counters, but not the client-visible ones (gets, sets, hits, misses,
  their bytes), and count in ``replica_writes``; a mirror is never served
  from, nor fills, the L0 tier.
* ``sanitize=True`` runs the invariant checks of
  ``analysis/sanitize.py`` on the state the step produced.  They fold
  into one i64 word (tensor ops, no host sync): a trace driver passes
  its carried word as ``san_word`` and reads it after the segment; a
  step called on its own reads its word at once and raises.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core import priority as prio
from repro_torch.core import spans
from repro_torch.core.fc_cache import fc_access, fc_access_group
from repro_torch.core.hashing import bucket_of, hash_key
from repro_torch.core.types import (SIZE_EMPTY, SIZE_HISTORY, CacheConfig,
                                    CacheState, ClientState, MDView, OpStats,
                                    _weight_shape, init_cache, init_clients,
                                    init_stats, stats_add)
from repro_torch.core.u32 import M32
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

I64 = torch.int64
F32 = torch.float32
_INF = float("inf")


class AccessResult(NamedTuple):
    hit: torch.Tensor       # bool[G, C]
    value: torch.Tensor     # u32[G, C, W] (garbage where miss)
    evicted: torch.Tensor   # bool[G, C]
    regret: torch.Tensor    # bool[G, C]


def _md_view(state: CacheState, idx: torch.Tensor,
             ts: torch.Tensor | None = None) -> MDView:
    size = state.size[idx].to(F32)
    clock = state.clock if ts is None else ts
    return MDView(
        size=size,
        insert_ts=state.insert_ts[idx].to(F32),
        last_ts=state.last_ts[idx].to(F32),
        freq=state.freq[idx].to(F32),
        ext=state.ext[idx],
        clock=clock.to(F32),
        gds_L=state.gds_L,
        cost=torch.ones_like(size),
    )


def _is_live(size: torch.Tensor) -> torch.Tensor:
    return (size != SIZE_EMPTY) & (size != SIZE_HISTORY)


def _hist_age(hist_ctr: torch.Tensor, hist_id: torch.Tensor) -> torch.Tensor:
    """Logical-FIFO age with wrap-around."""
    return (hist_ctr - hist_id) & M32


def _argmax(mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """First index of the max along ``dim`` of a boolean mask (0 if none)."""
    return mask.to(torch.int32).argmax(dim=dim)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x [B, N]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _take_expert(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x[b, :, e[b]] for x [B, N, E]; NaN where e[b] >= E, as the JAX
    package's ``take_along_axis`` fills an out-of-range gather."""
    B, N, E = x.shape
    got = torch.gather(x, 2, torch.clamp(e, max=E - 1)[:, None, None]
                       .expand(B, N, 1))[:, :, 0]
    return torch.where((e < E)[:, None], got, float("nan"))


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.repeat(x, n, axis=0): each leading entry n times in a row."""
    return x.unsqueeze(1).expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])


# Float sums in XLA's CPU order (f32 adds, one at a time), so that the
# expert cdf, the penalty sums and the weight syncs match the JAX
# package's bits.  PyTorch's CPU scan adds in f64 and rounds each output,
# and its CPU and CUDA sums are pairwise or vectorized, so on the CPU the
# adds run one row at a time.  On the card PyTorch's scan over a dim with
# more than one element after it is sequential in f32 (one operator); a
# scan with nothing after its dim is parallel, so a lone column is
# widened to two first.  ``chip_smoke.py`` holds these against a host f32
# loop on the card.

def _seqscan(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive scan over ``dim``, f32 adds in index order."""
    if x.device.type == "cuda":
        if math.prod(x.shape[dim + 1:]) == 1:
            wide = x.unsqueeze(-1).expand(*x.shape, 2)
            return torch.cumsum(wide, dim=dim)[..., 0]
        return torch.cumsum(x, dim=dim)
    rows = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        rows.append(rows[-1] + x.select(dim, i))
    return torch.stack(rows, dim=dim)


def _seqsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in index order: ``((x0 + x1) + x2) + ...``, as
    XLA's scatter-add visits a group's requests."""
    return _seqscan(x, dim).select(dim, -1)


def _xla_chunks(n: int) -> list:
    """The row ranges XLA's CPU reduce of a major axis sums one at a time:
    all n rows up to 32; above that ceil(n / 32) ranges, the middle ones
    of 32 rows and the rest split evenly between the first (which takes
    the odd row) and the last.  The range sums are then reduced by the
    same rule (``_xla_sum0``): in order up to 32 of them (n <= 1,024),
    else in ranges again.  Probed against jitted ``jnp.sum(axis=0)`` at
    1 to 70,000 rows."""
    if n <= 32:
        return [(0, n)]
    k = -(-n // 32)
    mid = 32 * (k - 2)
    first = -(-(n - mid) // 2)
    starts = [0, first] + [first + 32 * i for i in range(1, k - 1)]
    return list(zip(starts, starts[1:] + [n]))


def _xla_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in the order of XLA's CPU reduce (``_xla_chunks``),
    recursing on the range sums until one range is left:
    ``jnp.sum(x, axis=0)``."""
    spans = _xla_chunks(x.shape[0])
    if len(spans) == 1:
        return _seqsum(x)
    sizes = {b - a for a, b in spans}
    if len(sizes) == 1:                     # equal ranges: one reshape
        parts = _seqsum(x.reshape(len(spans), sizes.pop(), *x.shape[1:]), 1)
    else:
        parts = torch.stack([_seqsum(x[a:b]) for a, b in spans])
    return _xla_sum0(parts)


def _seqsum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in index order: ``jnp.sum(x, axis=-1)``."""
    return _seqsum(x.movedim(-1, 0))


def _seqcumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dim in index order, contiguous:
    ``jnp.cumsum(x, axis=-1)``."""
    return _seqscan(x.movedim(-1, 0)).movedim(0, -1).contiguous()


def _run_edges(idx: torch.Tensor, last: bool = False) -> torch.Tensor:
    """bool[B]: True for the first (``last``: the last) entry, in index
    order, of each distinct value of ``idx`` (a stable sort of the B
    entries, on 32-bit keys: slots and buckets fit, and the radix sort
    takes half the passes; no scratch column the size of the table)."""
    # A stable sort of the B entries, not the table.  dittolint: disable=DL003
    s, order = torch.sort(idx.to(torch.int32), stable=True)
    edge = torch.ones_like(s, dtype=torch.bool)
    if last:
        edge[:-1] = s[:-1] != s[1:]
    else:
        edge[1:] = s[1:] != s[:-1]
    return torch.empty_like(edge).scatter_(0, order, edge)


def _lww_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with every entry but the last (highest request position)
    of each slot set to the dropped index ``n``: last-writer-wins."""
    return torch.where(_run_edges(idx, last=True), idx, n)


def _expert_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The cumulative distribution [..., E] of the normalized weights."""
    p = weights / torch.clamp(_seqsum_last(weights)[..., None], min=1e-30)
    return _seqcumsum_last(p)


def _choose_expert(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample an expert index ~ the distribution ``cdf`` [..., E]."""
    return (cdf < u[..., None]).sum(dim=-1)


def apply_penalties(weights: torch.Tensor, penalties: torch.Tensor,
                    lam) -> torch.Tensor:
    """Multiplicative-weights regret update, clamp-THEN-normalize."""
    w = weights * torch.exp(-lam * penalties)
    w = torch.clamp(w, min=1e-4)
    return w / _seqsum_last(w)[..., None]


def _first_winner(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[B]: True for the first occurrence of each distinct value of x
    among valid lanes (the earliest request wins)."""
    return valid & _run_edges(torch.where(valid, x, -1))


# The table columns the step writes (in place in access_group_), on every
# config; a multi-tenant config's step also writes the slots' tenant
# column, and an L0 config's the bucket versions (written_columns).
WRITTEN = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts", "freq",
           "ext", "values")


def written_columns(cfg: CacheConfig) -> tuple:
    """The state columns ``cfg``'s step writes in place: ``WRITTEN``, and
    ``tenant`` when ``n_tenants > 1``, ``bucket_ver`` when
    ``l0_entries > 0``."""
    return (WRITTEN + (("tenant",) if cfg.n_tenants > 1 else ())
            + (("bucket_ver",) if cfg.l0_entries > 0 else ()))


def access_group(cfg: CacheConfig, state: CacheState, clients: ClientState,
                 stats: OpStats, keys: torch.Tensor, **kw
                 ) -> Tuple[CacheState, ClientState, OpStats, AccessResult]:
    """One batched cache step over a [G, C] request group, functional:
    the caller's tensors stay as they are.  :func:`access_group_` on
    copies of the columns the step writes; the same arguments."""
    state = state._replace(**{f: getattr(state, f).clone()
                              for f in written_columns(cfg)})
    return access_group_(cfg, state, clients, stats, keys, **kw)


def access_group_(cfg: CacheConfig, state: CacheState, clients: ClientState,
                  stats: OpStats, keys: torch.Tensor, *,
                  is_write: torch.Tensor | None = None,
                  obj_size: torch.Tensor | None = None,
                  values: torch.Tensor | None = None,
                  tenant: torch.Tensor | None = None,
                  insert_on_miss: bool = True,
                  shadow: torch.Tensor | None = None,
                  san_word: torch.Tensor | None = None,
                  ) -> Tuple[CacheState, ClientState, OpStats, AccessResult]:
    """One batched cache step over a [G, C] request group, in place: the
    table columns of ``state`` (:func:`written_columns`) take the step's
    writes, and the returned state holds those very tensors.  The caller
    owns them; ``clients`` and ``stats`` are not written.  ``state`` may
    be a view of a larger table (a DM shard's slice): the step writes its
    columns only in place and rebinds only its scalars.

    Args:
      keys: u32[G, C]; 0 marks a padded no-op lane.
      is_write: bool[G, C] — SET ops.
      obj_size: u32[G, C] object size in 64B blocks (default 1).
      values: u32[G, C, W] payload written on insert/set.
      tenant: u32[G, C] tenant ids in [0, n_tenants) (larger ids count as
        the last tenant); ignored when ``n_tenants == 1``.
      shadow: bool[G, C] — write-through replica mirrors (DM layer);
        ``None`` is all-False.
      san_word: with ``cfg.sanitize``, the trace driver's i64 word that
        the step's checks fold into (in place); ``None`` reads them at
        once and raises.
    """
    G, C = keys.shape
    B = G * C
    E = cfg.n_experts
    K = cfg.n_samples
    A = cfg.assoc
    Tn = cfg.n_tenants
    multi = Tn > 1
    l0 = cfg.l0_entries > 0
    names = cfg.experts
    adaptive = E > 1
    fused = cfg.backend == "fused"
    if fused:
        unsupported = [n for n in names if n not in kops.KERNEL_EXPERTS]
        if unsupported:
            raise ValueError(
                f"backend='fused' supports experts {kops.KERNEL_EXPERTS}; "
                f"got {unsupported} (use backend='reference')")
    dev = keys.device
    n_slots = cfg.n_slots

    if is_write is None:
        is_write = torch.zeros((G, C), dtype=torch.bool, device=dev)
    if obj_size is None:
        obj_size = torch.ones((G, C), dtype=I64, device=dev)
    if values is None:
        values = torch.zeros((G, C, cfg.value_words), dtype=I64, device=dev)

    keys_b = keys.reshape(B).to(I64)
    op = keys_b != 0
    is_write = is_write.reshape(B)
    obj_size = torch.clamp(obj_size.reshape(B).to(I64), 1, SIZE_HISTORY - 1)
    values = values.reshape(B, cfg.value_words).to(I64).contiguous()
    if multi or l0 or not fused:
        lane_b = torch.arange(C, device=dev).repeat(G)        # [B]
    if multi:
        tenant_b = (torch.zeros(B, dtype=I64, device=dev) if tenant is None
                    else torch.clamp(tenant.reshape(B).to(I64), max=Tn - 1))
        # Each request's tenant as a one-hot row [B, T]: the per-tenant
        # sums below are masked sums over it.
        own = tenant_b[:, None] == torch.arange(Tn, device=dev)[None, :]

    clock = state.clock
    ts_round = (clock + torch.arange(G, device=dev)) & M32        # [G]
    ts_req = ts_round[:, None].expand(G, C).contiguous().reshape(B)  # [B]

    # 1a. The L0 near-cache probe (DESIGN.md §15): a lane's valid entry
    #     (its bucket's version token and the flush epoch current) serves
    #     a plain GET, which then runs below as a padded no-op (key 0).
    if l0:
        # Only plain GETs are served locally: writes and replica mirrors
        # travel to the pool, so they bump the bucket's version.
        servable = op & ~is_write
        if shadow is not None:
            servable = servable & ~shadow.reshape(B)
        ent_bkt = torch.clamp(clients.l0_bkt, 0, cfg.n_buckets - 1)
        ent_present = clients.l0_key != 0                     # [C, L0]
        ent_valid = (ent_present
                     & (clients.l0_seen_epoch == state.l0_epoch)[:, None]
                     & (clients.l0_tok == state.bucket_ver[ent_bkt]))
        l0_stale = ent_present & ~ent_valid
        l0_match = (ent_valid[lane_b]
                    & (clients.l0_key[lane_b] == keys_b[:, None]))  # [B, L0]
        l0_idx = _argmax(l0_match)                            # [B]
        l0_hit = l0_match.any(dim=1) & servable
        l0_value = clients.l0_val[lane_b, l0_idx]             # [B, W]
        l0_size = clients.l0_sz[lane_b, l0_idx]               # [B]
        keys_b = torch.where(l0_hit, 0, keys_b)
        op = keys_b != 0

    # 1. Bucket probe (+ the embedded-history match).  The fused probe
    #    also returns what the insert path (4) needs of the same bucket.
    if fused:
        found, slot, hist_found, hslot, facts = kops.access_probe_op(
            state.key, state.size, state.key_hash, state.ptr, keys_b,
            state.hist_ctr, assoc=A, history_len=cfg.history_len,
            meta=(state.insert_ts, state.last_ts, state.freq), ts=ts_req,
            experts=names)
        kh, bucket = facts.key_hash, facts.bucket
        found = found & op
        hist_found = hist_found & op
        slot = torch.where(found, slot, -1)
    else:
        kh = hash_key(keys_b)
        bucket = bucket_of(kh, cfg.n_buckets)
        bslots = bucket[:, None] * A + torch.arange(A, device=dev)[None, :]
        b_key = state.key[bslots]
        b_size = state.size[bslots]
        b_hash = state.key_hash[bslots]
        b_ptr = state.ptr[bslots]

        live = _is_live(b_size)
        is_hist = b_size == SIZE_HISTORY
        h_age = _hist_age(state.hist_ctr, b_ptr)
        h_valid = is_hist & (h_age < cfg.history_len)

        match = live & (b_key == keys_b[:, None]) & op[:, None]
        found = match.any(dim=1)
        slot = torch.where(found, _pick(bslots, _argmax(match)), -1)
        h_match = h_valid & (b_hash == kh[:, None]) & op[:, None]
        hist_found = h_match.any(dim=1) & ~found
        hslot = _pick(bslots, _argmax(h_match))
    regret = hist_found & (adaptive and cfg.use_lwh)

    hit = found
    miss = op & ~found

    # 2. Hit-metadata update; the FC cache combines freq increments.
    slot_hit = torch.where(hit, slot, -1)
    if G == 1:
        clients, em = fc_access(cfg, clients, slot_hit, clock)
        emit_slot, emit_delta = em.slot.reshape(-1), em.delta.reshape(-1)
        n_faa, n_fc_hit = em.n_faa, em.n_hit
    else:
        clients, emit_slot, emit_delta, n_faa, n_fc_hit = fc_access_group(
            cfg, clients, slot_hit.reshape(G, C), ts_round)
        emit_slot = emit_slot.reshape(-1)
        emit_delta = emit_delta.reshape(-1)

    upd_idx = torch.where(hit, slot, n_slots)
    slot0 = torch.clamp(slot, min=0)
    emit_slot = emit_slot.contiguous()
    emit_delta = emit_delta.contiguous()
    if not fused:
        # The plain update's rows, from the step-entry columns (written in
        # step 6 with the FAA): ts_eff is the max hit timestamp on a slot.
        eff = state.clock.new_zeros((n_slots + 1,)).scatter_reduce(
            0, upd_idx, ts_req, "amax")[slot0]
        hit_last = torch.maximum(state.last_ts[slot0], eff)
        hit_ext = prio.update_ext(state.ext[slot0], state.last_ts[slot0],
                                  state.freq[slot0], eff)

    # 3. Regret collection + lazy expert-weight update (§4.3.2), in
    #    [C, T, E] space: each request's penalty lands on its own tenant's
    #    row (a single tenant: T = 1).
    hslot0 = torch.clamp(hslot, min=0)
    h_bmap = state.insert_ts[hslot0]                          # expert bitmap
    h_age_sel = _hist_age(state.hist_ctr, state.ptr[hslot0])
    h_age_f = h_age_sel.to(F32)
    pen = torch.pow(torch.full_like(h_age_f, cfg.discount), h_age_f)  # d^t
    bits = ((h_bmap[:, None] >> torch.arange(E, device=dev)[None, :])
            & 1).to(F32)
    pen_e = torch.where(regret[:, None], pen[:, None] * bits, 0.0)  # [B, E]
    # Per-(lane, tenant) sums over the group's rounds, in round order
    # (another tenant's rows add an exact 0.0).
    if multi:
        pen_lane = _seqsum(torch.where(own[:, :, None], pen_e[:, None, :],
                                       0.0).reshape(G, C, Tn, E))  # [C, T, E]
        reg_lane = (own & regret[:, None]).reshape(G, C, Tn).sum(dim=0)
        lw3, pacc3, pcnt2 = (clients.local_weights, clients.penalty_acc,
                             clients.penalty_cnt)
        w2 = state.weights                                    # [T, E]
    else:
        pen_lane = _seqsum(pen_e.reshape(G, C, E))[:, None, :]  # [C, 1, E]
        reg_lane = regret.reshape(G, C).sum(dim=0)[:, None]  # [C, 1]
        lw3, pacc3, pcnt2 = (clients.local_weights[:, None],
                             clients.penalty_acc[:, None],
                             clients.penalty_cnt[:, None])
        w2 = state.weights[None]                              # [1, E]

    lam = cfg.learning_rate
    local_w = lw3 * torch.exp(-lam * pen_lane)
    pacc = pacc3 + pen_lane
    pcnt = pcnt2 + reg_lane
    if cfg.use_lwu:
        syncing = pcnt >= cfg.sync_period                    # [C, T]
    else:
        syncing = reg_lane > 0
    tot_pen = _xla_sum0(torch.where(syncing[..., None], pacc, 0.0))  # [T, E]
    gw = apply_penalties(w2, tot_pen, lam)                    # [T, E]
    local_w = torch.where(syncing[..., None], gw[None], local_w)
    local_w = torch.clamp(local_w, min=1e-4)
    pacc = torch.where(syncing[..., None], 0.0, pacc)
    pcnt = torch.where(syncing, 0, pcnt)
    n_sync = syncing.sum()
    # Each (lane, tenant)'s expert distribution; one threefry draw per
    # request gives its expert choice and sampling offset: in the fused
    # backend the eviction kernel draws both (5).
    cdf = _expert_cdf(local_w if multi else local_w[:, 0])   # [C, (T,) E]
    if not fused:
        rng_b = clients.rng.repeat(G, 1)                      # [B, 2]
        u2 = prng.uniform(prng.fold_in(rng_b, ts_req), 2)     # [B, 2]
        e_choice = _choose_expert(cdf[lane_b, tenant_b] if multi
                                  else cdf[lane_b], u2[:, 0])  # [B]

    # 4. Inserts: read-through on miss, one per bucket per step.
    want_insert = miss & (is_write | insert_on_miss)
    winner = _first_winner(bucket, want_insert)
    dropped = want_insert & ~winner

    if fused:
        free_slot, has_free = facts.free_slot, facts.has_free
        fb_hist_slot, has_valid_hist = facts.hist_slot, facts.has_hist
        has_live = facts.has_live
    else:
        free = (b_size == SIZE_EMPTY) | (is_hist & ~h_valid)  # [B, A]
        has_free = free.any(dim=1)
        free_slot = _pick(bslots, _argmax(free))

        b_md = _md_view(state, bslots, ts_req[:, None])
        b_prio_e = _take_expert(prio.priorities(b_md, names), e_choice)
        b_prio_e = torch.where(live, b_prio_e, _INF)
        fb_obj_slot = _pick(bslots, b_prio_e.argmin(dim=1))
        hist_age_in_bucket = torch.where(h_valid, h_age.to(F32), -_INF)
        fb_hist_slot = _pick(bslots, hist_age_in_bucket.argmax(dim=1))
        has_valid_hist = h_valid.any(dim=1)
        has_live = live.any(dim=1)

    fallback_hist = winner & ~has_free & has_valid_hist
    fallback_obj = winner & ~has_free & ~has_valid_hist & has_live
    plain = winner & has_free
    ins_ok = plain | fallback_hist | fallback_obj
    dropped = dropped | (winner & ~ins_ok)

    # 5. Global sampled eviction against the byte budget.
    consumes = plain | fallback_hist
    old_sz = state.size[slot0]
    set_growth = torch.where(hit & is_write, obj_size - old_sz, 0)
    growing_set = hit & is_write & (set_growth > 0)
    chargers = consumes | growing_set
    n_charge = chargers.sum()
    inc_blocks = torch.where(consumes, obj_size, 0).sum() + set_growth.sum()
    over = state.bytes_cached + inc_blocks - state.capacity_blocks
    nc = torch.clamp(n_charge, min=1)
    quota = torch.where(over <= 0, 0, torch.clamp((over + nc - 1) // nc,
                                                  min=1))
    # Tenant-scoped budgets (§11): an over-budget tenant's chargers peel
    # their ceil-share of the tenant's deficit from its own slots (the
    # sample filter tfilt); the others share the pool's global quota.
    if multi:
        occ_t, bud_t = state.tenant_bytes, state.tenant_budget
        charge_d = torch.where(consumes, obj_size, 0) + set_growth   # [B]
        inc_t = torch.where(own, charge_d[:, None], 0).sum(dim=0)   # [T]
        n_charge_t = (own & chargers[:, None]).sum(dim=0)           # [T]
        over_t = occ_t + inc_t - bud_t
        nc_t = torch.clamp(n_charge_t, min=1)
        quota_t = torch.where(over_t <= 0, 0,
                              torch.clamp((over_t + nc_t - 1) // nc_t, min=1))
        scoped = chargers & (over_t[tenant_b] > 0)            # [B]
        must_evict = scoped | (chargers & (over > 0))
        quota_b = torch.where(scoped, quota_t[tenant_b], quota)  # [B]
        tfilt = torch.where(scoped, tenant_b, -1)             # [B]
        scope = dict(tenant=state.tenant, tfilt=tfilt)
    else:
        must_evict = chargers & (over > 0)
        quota_b = quota
        scope = {}

    W = cfg.sample_window or 4 * K
    if fused:
        # The kernel draws each op's offset and expert choice; it returns
        # the victims' expert bitmaps too.
        victims_2d, cand_slot, e_choice, bmap_2d = (
            kops.ranked_eviction_draw_op(
                state.size, state.insert_ts, state.last_ts, state.freq,
                clients.rng, cdf, must_evict, quota_b, ts_req, window=W, k=K,
                experts=names, op_tenant=tenant_b if multi else None,
                **scope))                                     # [B, K], [B, E]
        fb_obj_slot = _pick(facts.cand, e_choice)
    else:
        offs = torch.clamp((u2[:, 1] * n_slots).to(I64), max=n_slots - 1)
        samp = (offs[:, None]
                + torch.arange(W, device=dev)[None, :]) % n_slots  # [B, W]
        s_md = _md_view(state, samp, ts_req[:, None])
        s_elig = _is_live(state.size[samp])
        if multi:
            # A budget-scoped op samples only its own tenant's objects.
            s_elig = s_elig & ((tfilt[:, None] < 0)
                               | (state.tenant[samp] == tfilt[:, None]))
        s_live = s_elig & (torch.cumsum(s_elig.to(I64), dim=1) <= K)
        s_prio = prio.priorities(s_md, names)                 # [B, W, E]
        s_prio = torch.where(s_live[:, :, None], s_prio, _INF)
        cand_slot = torch.gather(samp, 1, s_prio.argmin(dim=1))  # [B, E]

        # Peel the chosen expert's ranking until the quota is covered.
        prio_e = _take_expert(s_prio, e_choice)               # [B, W]
        s_blocks = torch.where(s_live, s_md.size, 0.0)
        cols = torch.arange(W, device=dev)[None, :]
        quota_f = quota_b.to(F32)
        vs = []
        freed = torch.zeros((B,), dtype=F32, device=dev)
        for _ in range(K):
            arg = prio_e.argmin(dim=1)
            ok = (freed < quota_f) & (_pick(prio_e, arg) < _INF) & must_evict
            vs.append(torch.where(ok, _pick(samp, arg), -1))
            freed = freed + torch.where(ok, _pick(s_blocks, arg), 0.0)
            prio_e = torch.where(cols == arg[:, None], _INF, prio_e)
        victims_2d = torch.stack(vs, dim=1)                   # [B, K]
    V = victims_2d.shape[1]
    victims = victims_2d.reshape(-1)                          # [B*V]
    ev_winner = _first_winner(victims, victims >= 0)
    n_evict = ev_winner.sum()
    evicting = must_evict & (victims_2d >= 0).any(dim=1)

    # 5b. The tenant budget gate (§11): charges (insert sizes, SET byte
    #     deltas) are admitted against each tenant's post-eviction
    #     allowance as a round-ordered running sum; the excess inserts
    #     and growing SETs are refused (insert_drops).
    if multi:
        v_idx = torch.clamp(victims, min=0)
        v_own = state.tenant[v_idx][:, None] == torch.arange(
            Tn, device=dev)[None, :]                          # [B*V, T]
        freed_t = torch.where(v_own & ev_winner[:, None],
                              state.size[v_idx][:, None], 0).sum(dim=0)
        allow_t = bud_t - occ_t + freed_t                     # [T]
        charge_seq = torch.where(ins_ok, obj_size, 0) + set_growth
        # Each tenant's running charge in request order, scanned as [T, B]
        # rows: CUDA's scan over the outer dim of [B, T] is one thread a
        # column (~250 us a step at B = 2048, T = 3).
        cum = torch.cumsum(torch.where(own.T, charge_seq[None, :], 0), dim=1)
        cum_own = torch.gather(cum, 0, tenant_b[None, :])[0]  # [B]
        cancel = (ins_ok | growing_set) & (cum_own > allow_t[tenant_b])
        plain = plain & ~cancel
        fallback_hist = fallback_hist & ~cancel
        fallback_obj = fallback_obj & ~cancel
        ins_ok = ins_ok & ~cancel
        dropped = dropped | cancel
        set_ok = hit & is_write & ~(growing_set & cancel)
    else:
        set_ok = hit & is_write
    ins_slot = torch.where(plain, free_slot,
                           torch.where(fallback_hist, fb_hist_slot,
                                       fb_obj_slot))

    # Expert bitmap per victim: matching candidates + the chosen expert.
    if fused:
        bmap = bmap_2d.reshape(-1)                            # [B*V]
    else:
        cand_rep = _repeat(cand_slot, V)                      # [B*V, E]
        e_rep = _repeat(e_choice, V)                          # [B*V]
        bmap = ((cand_rep == victims[:, None]).to(I64)
                << torch.arange(E, device=dev)[None, :]).sum(dim=1)
        bmap = bmap | (1 << e_rep)

    # GreedyDual inflation: L <- max(L, evicted victim's H).
    gds_L = state.gds_L
    gds_ids = [i for i, n in enumerate(names) if prio.REGISTRY[n].gds_family]
    if gds_ids:
        v_md = _md_view(state, torch.clamp(victims, min=0), _repeat(ts_req, V))
        vp = prio.priorities(v_md, names)[:, gds_ids]
        vp = torch.where(ev_winner[:, None], vp, -_INF)
        gds_L = torch.maximum(gds_L, vp.max())

    # History insertion (FAA on the global counter + slot tag + bitmap).
    write_hist = ev_winner & (adaptive and cfg.use_lwh)
    hist_rank = torch.cumsum(write_hist.to(I64), dim=0) - 1
    hist_ids = (state.hist_ctr + hist_rank) & M32
    n_hist = write_hist.sum()

    result_vals = state.values[slot0]
    set_idx = torch.where(set_ok, slot, n_slots)
    if multi:
        # Every slot the apply writes, once each (a victim may be another
        # op's insert target), with its step-entry tenant and live size:
        # tenant_bytes moves by the written slots' change (integers, so
        # exact in any order; no pass over the table).
        w_idx = torch.cat([set_idx, torch.where(ins_ok, ins_slot, n_slots),
                           torch.where(ev_winner, victims, n_slots)])
        w_first = (w_idx < n_slots) & _run_edges(w_idx)
        w_at = torch.clamp(w_idx, max=n_slots - 1)

        def _live_bytes():
            sz = state.size[w_at]
            live_sz = torch.where(w_first & _is_live(sz), sz, 0)
            return torch.where(state.tenant[w_at][:, None] == torch.arange(
                Tn, device=dev)[None, :], live_sz[:, None], 0).sum(dim=0)
        bytes_before = _live_bytes()                          # [T]

    # 6. Apply, in place and in the JAX package's order: the hit metadata,
    #    then one drop_scatter of three write groups: SET payloads and
    #    sizes (last writer wins within the group), inserts, then
    #    evictions (so a victim that collides with a bucket-fallback
    #    overwrite target nets out exactly in n_cached).  Every read of
    #    the step-entry table is above this point.
    if fused:
        kops.hit_metadata_update_op_(state.freq, state.last_ts, state.ext,
                                     slot_hit, ts_req, emit_slot, emit_delta)
        write = kops.drop_scatter_groups_op_
    else:
        # The reference backend's own plain writes, as the JAX package's
        # reference backend runs XLA's.  dittolint: disable=DL005
        kref.drop_scatter_ref(upd_idx, (state.last_ts, state.ext),
                              (hit_last, hit_ext))
        # The FC-flush FAA: a no-op emit adds 0 to slot 0; then the u32
        # wrap at the slots it touched.
        state.freq.index_add_(0, torch.clamp(emit_slot, min=0),
                              torch.where(emit_slot >= 0, emit_delta, 0))
        # The reference backend's plain write.  dittolint: disable=DL005
        kref.drop_scatter_ref(emit_slot, (state.freq,),
                              (state.freq[torch.clamp(emit_slot, min=0)]
                               & M32,))
        write = kref.drop_scatter_groups_ref
    # The insert group writes 10 columns with the tenant's (2 + 10 + 3 =
    # 15 of drop_scatter's MAX_COLS = 16): one more column takes the last.
    ins_cols = tuple(getattr(state, f) for f in WRITTEN)
    ins_srcs = (keys_b, kh, obj_size, 0, ts_req, ts_req, 1,
                prio.fresh_ext(ts_req, (B,)), values)
    if multi:
        ins_cols, ins_srcs = ins_cols + (state.tenant,), ins_srcs + (tenant_b,)
    write(((_lww_idx(set_idx, n_slots), (state.values, state.size),
            (values, obj_size)),
           (ins_slot, ins_cols, ins_srcs, ins_ok),
           (victims, (state.size, state.ptr, state.insert_ts),
            ((write_hist, SIZE_HISTORY, SIZE_EMPTY), (write_hist, hist_ids, 0),
             bmap), ev_winner)))

    n_cached = state.n_cached + plain.sum() + fallback_hist.sum() - n_evict
    # Byte occupancy, recomputed exactly from the final size column: the
    # one whole-column read of the step, as in the JAX package.  Empty
    # slots hold size 0, so only history entries are masked.
    bytes_cached = torch.where(state.size == SIZE_HISTORY, 0,
                               state.size).sum()
    tenant_bytes = (occ_t + _live_bytes() - bytes_before if multi
                    else bytes_cached[None])

    # 6b. L0 coherence tokens + fill (DESIGN.md §15): every bucket that
    #     commits a SET, an insert or an eviction bumps its version once;
    #     each lane fills from its last plain GET hit on an untouched
    #     bucket (its step-entry content is the post-step content): same
    #     key, else the first empty entry, else the local LRU entry.
    if l0:
        ver0_b = state.bucket_ver[bucket]                     # step-entry
        t_idx = torch.cat([torch.where(set_ok | ins_ok, bucket, cfg.n_buckets),
                           torch.where(ev_winner, victims // A,
                                       cfg.n_buckets)])
        t_ver = state.bucket_ver[torch.clamp(t_idx, max=cfg.n_buckets - 1)]
        # The L0 bump is plain on both backends.  dittolint: disable=DL005
        kref.drop_scatter_ref(t_idx, (state.bucket_ver,), ((t_ver + 1) & M32,))
        untouched = state.bucket_ver[bucket] == ver0_b
        fill_ok = hit & ~is_write & untouched                 # [B]
        if shadow is not None:
            fill_ok = fill_ok & ~shadow.reshape(B)
        pos = torch.arange(B, device=dev)
        last_fill = torch.where(fill_ok, pos, -1).reshape(G, C).amax(dim=0)
        f_req = torch.clamp(last_fill, min=0)                 # [C] -> B idx
        do_fill = last_fill >= 0
        L0 = cfg.l0_entries
        # Drop stale entries, then stamp each entry that served an L0 hit
        # with its latest request's timestamp.
        key1 = torch.where(l0_stale, 0, clients.l0_key)
        last1 = torch.cat([clients.l0_last.reshape(-1),
                           clients.l0_last.new_zeros(1)]).scatter_reduce(
            0, torch.where(l0_hit, lane_b * L0 + l0_idx, C * L0), ts_req,
            "amax")[:C * L0].reshape(C, L0)
        fill_key = keys_b[f_req]
        same = key1 == fill_key[:, None]                      # [C, L0]
        empty = key1 == 0
        pick = torch.where(same.any(dim=1), _argmax(same),
                           torch.where(empty.any(dim=1), _argmax(empty),
                                       last1.argmin(dim=1)))  # [C]
        at = do_fill[:, None] & (torch.arange(L0, device=dev)[None, :]
                                 == pick[:, None])            # [C, L0]
        fill = lambda x, col: torch.where(
            at.reshape(at.shape + (1,) * (col.dim() - 2)),
            x.reshape((C, 1) + col.shape[2:]), col)
        l0_upd = dict(
            l0_key=fill(fill_key, key1),
            l0_bkt=fill(bucket[f_req], clients.l0_bkt),
            l0_tok=fill(ver0_b[f_req], clients.l0_tok),
            l0_sz=fill(old_sz[f_req], clients.l0_sz),
            l0_val=fill(result_vals[f_req], clients.l0_val),
            l0_last=fill(ts_req[f_req], last1),
            l0_seen_epoch=state.l0_epoch.repeat(C))

    new_state = state._replace(
        n_cached=n_cached, bytes_cached=bytes_cached,
        hist_ctr=(state.hist_ctr + n_hist) & M32,
        clock=(clock + G) & M32, weights=gw if multi else gw[0], gds_L=gds_L,
        tenant_bytes=tenant_bytes)
    new_clients = clients._replace(
        local_weights=local_w if multi else local_w[:, 0],
        penalty_acc=pacc if multi else pacc[:, 0],
        penalty_cnt=pcnt if multi else pcnt[:, 0],
        **(l0_upd if l0 else {}))

    # 7. Remote-op accounting (the paper's cost model).
    n_op = op.sum()
    n_hit = hit.sum()
    n_miss = miss.sum()
    n_set = (op & is_write).sum()
    n_ins = ins_ok.sum()
    n_evicting = evicting.sum()
    n_write_hist = write_hist.sum()
    sf = cfg.use_sfht
    no_sep = cfg.use_lwh or not adaptive
    reads = (n_op + (0 if sf else n_hit) + n_hit
             + (0 if no_sep else n_miss)
             + n_evicting * (1 if sf else K))
    sep_hist = 0 if no_sep else n_evict
    writes = (n_hit * (1 if sf else 2) + n_ins * 2 + n_write_hist
              + sep_hist * 2)
    cas = n_ins + ev_winner.sum()
    faa = n_faa + n_hist + sep_hist
    SLOT_B = 32
    hit_blocks = torch.where(hit, old_sz, 0).sum()
    miss_blocks = torch.where(miss, obj_size, 0).sum()
    ins_blocks = torch.where(ins_ok, obj_size, 0).sum()
    set_blocks = torch.where(hit & is_write, obj_size, 0).sum()
    read_b = (n_op * A * SLOT_B
              + (0 if sf else n_hit * SLOT_B)
              + hit_blocks * 64
              + (0 if no_sep else n_miss * SLOT_B)
              + n_evicting * (W if sf else K) * SLOT_B)
    write_b = (n_hit * (SLOT_B // 2 if sf else SLOT_B)
               + ins_blocks * 64 + n_ins * SLOT_B
               + set_blocks * 64
               + n_write_hist * 16 + sep_hist * SLOT_B)
    if shadow is None:
        gets, sets, hits, misses = n_op - n_set, n_set, n_hit, n_miss
        hit_bytes, miss_bytes = hit_blocks * 64, miss_blocks * 64
        mirrors = {}
    else:
        # Mirrors move the RDMA counters above but are replication
        # traffic, not offered load: the client-visible counters skip
        # them and replica_writes counts them.
        sh = shadow.reshape(B) & op
        vis = op & ~sh
        sets = (vis & is_write).sum()
        gets, hits, misses = (vis.sum() - sets, (hit & ~sh).sum(),
                              (miss & ~sh).sum())
        hit_bytes = torch.where(hit & ~sh, old_sz, 0).sum() * 64
        miss_bytes = torch.where(miss & ~sh, obj_size, 0).sum() * 64
        mirrors = dict(replica_writes=sh.sum())
    if l0:
        # L0 hits are client-visible gets and hits that move no RDMA
        # counter; they rejoin the caller's result.
        n_l0_hit = l0_hit.sum()
        gets, hits = gets + n_l0_hit, hits + n_l0_hit
        hit_bytes = hit_bytes + torch.where(l0_hit, l0_size, 0).sum() * 64
        stats = stats_add(stats, l0_hits=n_l0_hit,
                          l0_invalidations=l0_stale.sum())
        hit = hit | l0_hit
        result_vals = torch.where(l0_hit[:, None], l0_value, result_vals)
    stats = stats_add(
        stats, rdma_read=reads, rdma_write=writes, rdma_cas=cas,
        rdma_faa=faa, rpc=n_sync, gets=gets, sets=sets,
        rdma_read_bytes=read_b, rdma_write_bytes=write_b,
        hit_bytes=hit_bytes, miss_bytes=miss_bytes,
        hits=hits, misses=misses, regrets=regret.sum(),
        evictions=n_evict, bucket_evictions=fallback_obj.sum(),
        insert_drops=dropped.sum(), fc_hits=n_fc_hit, fc_flushes=n_faa,
        weight_syncs=n_sync, **mirrors)

    if cfg.sanitize:
        from repro_torch.analysis import sanitize as san
        word = san.step_word(cfg, state, new_state, new_clients)
        if san_word is None:
            san.report(word)
        else:
            san.merge_(san_word, word)

    return new_state, new_clients, stats, AccessResult(
        hit=hit.reshape(G, C), value=result_vals.reshape(G, C, -1),
        evicted=evicting.reshape(G, C), regret=regret.reshape(G, C))


def access(cfg: CacheConfig, state: CacheState, clients: ClientState,
           stats: OpStats, keys: torch.Tensor, *,
           is_write: torch.Tensor | None = None,
           obj_size: torch.Tensor | None = None,
           values: torch.Tensor | None = None,
           tenant: torch.Tensor | None = None,
           insert_on_miss: bool = True):
    """One single-round step (G=1) over keys u32[C]."""
    state, clients, stats, res = access_group(
        cfg, state, clients, stats, keys[None, :],
        is_write=None if is_write is None else is_write[None, :],
        obj_size=None if obj_size is None else obj_size[None, :],
        values=None if values is None else values[None],
        tenant=None if tenant is None else tenant[None, :],
        insert_on_miss=insert_on_miss)
    return state, clients, stats, AccessResult(
        hit=res.hit[0], value=res.value[0], evicted=res.evicted[0],
        regret=res.regret[0])


class TraceResult(NamedTuple):
    state: CacheState
    clients: ClientState
    stats: OpStats
    hits: torch.Tensor      # i64[R] per-round hit counts
    ops: torch.Tensor       # i64[R] per-round op counts
    weights: torch.Tensor   # f32[R, E] global weight trajectory
    #                         ([R, T, E] when n_tenants > 1)


def _leaves(tree) -> list:
    return [t for part in tree for t in part]


def _rebuild(tree, leaves) -> tuple:
    out, i = [], 0
    for part in tree:
        out.append(type(part)(*leaves[i:i + len(part)]))
        i += len(part)
    return tuple(out)


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    leaves: list        # the carry the graph reads and overwrites: its own
    #                     buffers, None where it runs on a donated column
    xs: tuple           # the step input it reads
    ys: tuple           # the step output it writes


# Captured steps, by (step key, device, carry and one step's input
# signatures, a donated carry's table addresses: the number of steps is
# not part of it), and one memory pool per device that they share:
# replays run one at a time on one stream, so no two graphs'
# intermediates are live together.  A donated graph is dropped at the
# next donated lookup once any of its table's storages is freed
# (``_GONE``): a copying scan's lookup leaves the cache as it is.
_GRAPHS: dict = {}
_POOLS: dict = {}
_GONE: list = []

# The state columns a donated scan runs on where the caller holds them:
# the table's slot and bucket columns, the carry's bulk.  The step
# writes them in place or returns them as they are.
TABLE = WRITTEN + ("tenant", "bucket_ver")


def capture_graph(fn, pool=None, warm=None):
    """Run ``warm()`` (``fn()`` if None) once on a side stream (the
    warm-up: kernel builds, cached constants, launch counters), then
    capture a call of ``fn()`` as a CUDA graph on the current device.
    Returns the graph and what the captured call returned; each replay
    rewrites those outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        (fn if warm is None else warm)()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def _sig(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _donated(carry, donate: bool) -> list:
    """For each leaf of ``carry``, whether a scan runs on it in place: the
    ``TABLE`` columns of its first part (the state) when ``donate``."""
    table = [donate and f in TABLE and getattr(carry[0], f).numel() > 0
             for f in carry[0]._fields]
    return table + [False] * (len(_leaves(carry)) - len(table))


def _captured_step(step, key, carry, xs, donate: bool = False) -> _Captured:
    """The graph of ``step`` for this key and these shapes, captured at
    first use: it reads one element of ``xs`` and a carry whose donated
    leaves (:func:`_donated`) are the caller's own and the rest a private
    copy, and overwrites that carry with the step's result.  A step that
    works in place returns the table columns it was given: those need
    no copy back; the rest (0-d counters, the client state) are copied.
    A donated graph is keyed on its columns' addresses as well, so a
    table is never replayed against another's memory."""
    while donate and _GONE:
        _GRAPHS.pop(_GONE.pop(), None)
    dev = xs[0].device
    table = [t for t, d in zip(_leaves(carry), _donated(carry, donate))
             if d]
    k = (key, dev, _sig(_leaves(carry)), _sig(x[0] for x in xs),
         tuple((t.data_ptr(), t.stride()) for t in table))
    if k in _GRAPHS:
        return _GRAPHS[k]
    with spans.span("ditto.capture"):
        _GRAPHS[k] = _capture(step, carry, xs, dev, donate)
    for s in {id(t.untyped_storage()): t.untyped_storage()
              for t in table}.values():
        weakref.finalize(s, _GONE.append, k).atexit = False
    spans.count("graph_captures")
    return _GRAPHS[k]


def _into(step, carry, leaves, x_s):
    """``run()``: ``step`` on ``carry``'s tree of ``leaves`` and the input
    ``x_s``, the new carry written into ``leaves``; returns the step's
    output."""
    carry_s = _rebuild(carry, leaves)
    inputs = {t.untyped_storage().data_ptr() for t in leaves}

    def run():
        new, y = step(carry_s, x_s)
        for dst, src in zip(leaves, _leaves(new)):
            if src is dst or src.numel() == 0:      # (no storage to alias)
                continue
            if src.untyped_storage().data_ptr() in inputs:
                raise RuntimeError("a step output aliases its input carry")
            dst.copy_(src)
        return y

    return run


def _padded(run, leaves, donated, x_s) -> None:
    """``run()`` with every lane of the step padded (its keys, the first
    input, 0), the carry's own leaves put back after it: the donated
    table columns, which no padded lane writes, stay as they were."""
    small = [t for t, d in zip(leaves, donated) if not d]
    kept = [t.clone() for t in small]
    x_s[0].zero_()
    run()
    for t, k in zip(small, kept):
        t.copy_(k)


def _capture(step, carry, xs, dev, donate: bool) -> _Captured:
    """The capture of :func:`_captured_step`: on a fresh copy of the
    carry, but for its donated leaves, which the graph reads and writes
    where the caller holds them.  A donated capture warms up on padded
    lanes (:func:`_padded`), so that warm-up applies no request to the
    caller's table and copies none of it."""
    donated = _donated(carry, donate)
    leaves = [t if d else t.clone()
              for t, d in zip(_leaves(carry), donated)]
    x_s = tuple(x[0].clone() for x in xs)
    run = _into(step, carry, leaves, x_s)
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    warm = (lambda: _padded(run, leaves, donated, x_s)) if donate else None
    with torch.cuda.device(dev):
        graph, y_s = capture_graph(run, _POOLS[dev], warm=warm)
    return _Captured(graph, [None if d else t
                             for t, d in zip(leaves, donated)], x_s, y_s)


_EAGER = []


@contextlib.contextmanager
def eager_steps():
    """``_scan`` runs its steps as a Python loop on every device, with no
    CUDA graph, while this is entered."""
    _EAGER.append(True)
    try:
        yield
    finally:
        _EAGER.pop()


def _scan(step, carry, xs, key, between=None, donate: bool = False):
    """``lax.scan`` of the JAX package: ``carry, y = step(carry, x)`` for
    each x along the leading axis of the tensors ``xs``; returns the last
    carry and the ys stacked (None for an empty sequence).  ``key`` names
    the step (what it computes, apart from the shapes of its tensors).
    ``between``, if given, runs after every step, outside the step (and
    its graph): ``carry = between(carry, y)``, e.g. a collective across
    processes whose result the next step reads.

    On the CPU this is a Python loop.  On the card the step is captured
    as a CUDA graph once per key, device and shapes, and replayed per
    element: the step issues no host sync and no upload, so the graph is
    the step, and a replay costs one launch instead of the step's
    thousand-odd operator launches.

    ``step`` may write its carry in place (``access_group_``).  Without
    ``donate`` no caller's tensor is written: on the CPU the loop runs on
    one copy of the caller's carry, made before it, and on the card the
    graph works on its own copy, the caller's tensors copied in and the
    result copied out.  With ``donate`` (the JAX package's buffer
    donation) the carry starts with a ``CacheState`` and ``xs`` with the
    steps' keys, and the scan consumes the caller's table: its ``TABLE``
    columns are read and written where they are, on the CPU and in the
    graph alike, and the carry returned holds those very tensors; the
    graph copies only the small leaves (scalars, weights, the client
    state, the counters) in and out.  The caller's other leaves stay as
    they were, so a donated carry is not to be read again.

    Inside :func:`eager_steps` the card runs the loop too, each step's
    operators launched one by one (the graph audit traces them)."""
    n = xs[0].shape[0]
    if n == 0:
        return carry, None
    if donate:
        spans.count("donated_scans")
    if xs[0].device.type != "cuda" or _EAGER:
        if not donate:
            with spans.span("ditto.scan.copy_in"):
                carry = _rebuild(carry, [t.clone() for t in _leaves(carry)])
        ys = []
        for i in range(n):
            with spans.span("ditto.scan.step"):
                carry, y = step(carry, tuple(x[i] for x in xs))
            if between is not None:
                carry = between(carry, y)
            ys.append(y)
        return carry, tuple(torch.stack(p) for p in zip(*ys))

    cap = _captured_step(step, key, carry, xs, donate)
    leaves = [src if buf is None else buf
              for buf, src in zip(cap.leaves, _leaves(carry))]
    with spans.span("ditto.scan.copy_in"):
        for buf, src in zip(cap.leaves, _leaves(carry)):
            if buf is not None:
                buf.copy_(src)
    ys = tuple(torch.empty((n,) + tuple(y.shape), dtype=y.dtype,
                           device=y.device) for y in cap.ys)
    for i in range(n):
        with spans.span("ditto.scan.step"):
            for dst, x in zip(cap.xs, xs):
                dst.copy_(x[i])
            cap.graph.replay()
            for buf, y in zip(ys, cap.ys):
                buf[i].copy_(y)
        if between is not None:
            new = between(_rebuild(carry, leaves), cap.ys)
            for dst, src in zip(leaves, _leaves(new)):
                if src is not dst:
                    dst.copy_(src)
    with spans.span("ditto.scan.copy_out"):
        out = [src if buf is None else buf.clone()
               for buf, src in zip(cap.leaves, leaves)]
    return _rebuild(carry, out), ys


def _san_carry(cfg: CacheConfig, dev) -> tuple:
    """A trace driver's optional carry part: with ``cfg.sanitize``, the
    sanitizer's word (``analysis/sanitize.py``), else nothing."""
    if not cfg.sanitize:
        return ()
    from repro_torch.analysis import sanitize as san
    return (san.Word(san.new_word(dev)),)


def _trace_carry(cfg: CacheConfig, state, clients, dev) -> tuple:
    """A trace driver's carry: (state, clients, fresh stats[, word])."""
    return (state, clients, init_stats(dev)) + _san_carry(cfg, dev)


def _san_kw(san: list) -> dict:
    """The step's ``san_word`` argument from the carry's optional part."""
    return {"san_word": san[0].word} if san else {}


def _read_word(san: list) -> None:
    """After a sanitized segment: raise the first failure its steps
    recorded (one host read), or defer it inside ``sanitize.checked``."""
    if san:
        from repro_torch.analysis import sanitize as san_mod
        san_mod.report(san[0].word)


def _trace_inputs(keys, is_write, obj_size, tenant):
    """The op tensors of a trace, with the defaults filled in."""
    z = torch.zeros_like(keys)
    return (keys, z.bool() if is_write is None else is_write,
            z + 1 if obj_size is None else obj_size,
            z if tenant is None else tenant)


def _run_trace_impl(cfg: CacheConfig, state: CacheState,
                    clients: ClientState, keys: torch.Tensor,
                    is_write: torch.Tensor | None = None,
                    obj_size: torch.Tensor | None = None,
                    tenant: torch.Tensor | None = None,
                    by_lane: bool = False,
                    donate: bool = False) -> TraceResult:
    """Run a [T, C] trace, one round per step.  ``by_lane``: hits and
    ops per round and lane ([T, C] bool) instead of per round.
    ``donate``: the scan consumes ``state``'s table (:func:`_scan`), and
    the result's state holds its columns."""

    def step(carry, xs):
        st, cl, sa, *san = carry
        k, w, sz, tn = (x[None] for x in xs)
        st, cl, sa, res = access_group_(cfg, st, cl, sa, k, is_write=w,
                                        obj_size=sz, tenant=tn,
                                        **_san_kw(san))
        carry = (st, cl, sa, *san)
        if by_lane:
            return carry, (res.hit[0], k[0] != 0, st.weights)
        return carry, (res.hit.sum(), (k != 0).sum(), st.weights)

    C = keys.shape[1]
    (state, clients, stats, *san), ys = _scan(
        step, _trace_carry(cfg, state, clients, keys.device),
        _trace_inputs(keys, is_write, obj_size, tenant),
        ("access", cfg, by_lane), donate=donate)
    _read_word(san)
    if ys is None:
        ys = _empty_ys(cfg, keys.device, (C,) if by_lane else ())
    return TraceResult(state, clients, stats, *ys)


def _group_step(cfg: CacheConfig, by_lane: bool):
    """The step of :func:`_run_trace_grouped_impl`: one [G, C] group of
    a (state, clients, stats[, word]) carry, in place."""

    def step(carry, xs):
        st, cl, sa, *san = carry
        k, w, sz, tn = xs
        st, cl, sa, res = access_group_(cfg, st, cl, sa, k, is_write=w,
                                        obj_size=sz, tenant=tn,
                                        **_san_kw(san))
        carry = (st, cl, sa, *san)
        if by_lane:
            return carry, (res.hit, k != 0, st.weights)
        return carry, (res.hit.sum(dim=1), (k != 0).sum(dim=1), st.weights)

    return step


def _run_trace_grouped_impl(cfg: CacheConfig, state: CacheState,
                            clients: ClientState, keys: torch.Tensor,
                            is_write: torch.Tensor | None = None,
                            obj_size: torch.Tensor | None = None,
                            tenant: torch.Tensor | None = None,
                            by_lane: bool = False,
                            donate: bool = False) -> TraceResult:
    """Run a planned [NG, G, C] grouped trace, one group per step.
    Per-round hit/op counts ([NG*G]; ``by_lane``: [NG*G, C] bool);
    weights repeat per round.  ``donate`` as :func:`_run_trace_impl`'s."""
    NG, G, C = keys.shape
    (state, clients, stats, *san), ys = _scan(
        _group_step(cfg, by_lane),
        _trace_carry(cfg, state, clients, keys.device),
        _trace_inputs(keys, is_write, obj_size, tenant),
        ("access_group", cfg, by_lane), donate=donate)
    _read_word(san)
    lane = (C,) if by_lane else ()
    if ys is None:
        ys = _empty_ys(cfg, keys.device, (G,) + lane)
    hits, ops, w = ys
    return TraceResult(state, clients, stats, hits.reshape((-1,) + lane),
                       ops.reshape((-1,) + lane), _repeat(w, G))


def _deprecated_entrypoint(name: str) -> None:
    import warnings
    warnings.warn(
        f"{name} is deprecated; drive traces through repro_torch.core."
        "execute() (DESIGN.md §13): it wraps the same engine behind one "
        "planned, width-adaptive surface", DeprecationWarning, stacklevel=3)


def run_trace(cfg: CacheConfig, state: CacheState, clients: ClientState,
              keys: torch.Tensor, is_write: torch.Tensor | None = None,
              obj_size: torch.Tensor | None = None,
              tenant: torch.Tensor | None = None) -> TraceResult:
    """Deprecated sequential trace runner: use ``repro_torch.core.execute``
    with ``plan=None`` (bit-identical results)."""
    _deprecated_entrypoint("run_trace")
    return _run_trace_impl(cfg, state, clients, keys, is_write, obj_size,
                           tenant)


def run_trace_grouped(cfg: CacheConfig, state: CacheState,
                      clients: ClientState, keys: torch.Tensor,
                      is_write: torch.Tensor | None = None,
                      obj_size: torch.Tensor | None = None,
                      tenant: torch.Tensor | None = None) -> TraceResult:
    """Deprecated grouped trace runner: use ``repro_torch.core.execute``
    with a precomputed plan or ``plan="adaptive"`` (bit-identical results
    for the same plan)."""
    _deprecated_entrypoint("run_trace_grouped")
    return _run_trace_grouped_impl(cfg, state, clients, keys, is_write,
                                   obj_size, tenant)


def _empty_ys(cfg: CacheConfig, dev, round_shape) -> tuple:
    return (torch.zeros((0,) + round_shape, dtype=I64, device=dev),
            torch.zeros((0,) + round_shape, dtype=I64, device=dev),
            torch.zeros((0,) + _weight_shape(cfg), dtype=F32, device=dev))


def make_cache(cfg: CacheConfig, n_clients: int, seed: int = 0, device=None):
    """A fresh (state, clients, stats) on ``device`` (default: the card;
    raises without one)."""
    return (init_cache(cfg, device), init_clients(cfg, n_clients, seed, device),
            init_stats(device))
