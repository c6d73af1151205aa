"""The plain reference of one Ditto cache step, frozen with the benchmark.

A straightforward PyTorch statement of the step's semantics: the bucket
probe and its embedded-history match, the hit metadata with the
client-side frequency-counter (FC) cache, the regrets and the lazy
expert-weight update, read-through inserts (one a bucket a step), the
sampled eviction ranked by an expert drawn from the lane's weights
(threefry-2x32 draws), the apply, and the ``OpStats`` metering.  It
covers what the benchmark's configurations state: one tenant, no L0
tier, experts among ``lru`` and ``lfu``.

Everything is computed here from the configuration, the seed and the
requests; nothing of the program under test is imported.  Integer
columns are int64 tensors holding u32 values, masked after each wrapping
add.  Float sums run in a fixed order (f32 adds one at a time in index
order; a reduce over many lanes in ranges of 32, then over the range
sums), so that the same requests give the same bits on any device.

State is held in plain dicts: ``state`` (the slot columns, written in
place by :func:`step`, and the scalars, replaced), ``clients`` (the
lanes) and ``stats`` (the counters).
"""

from __future__ import annotations

import math

import torch

I64 = torch.int64
F32 = torch.float32
M32 = 0xFFFFFFFF
INF = float("inf")

SIZE_EMPTY = 0
SIZE_HISTORY = 0xFF
EXT_WIDTH = 4
LRUK_K = 2
LRFU_LAMBDA = 0.05
LN2_F32 = float(torch.tensor(0.6931471805599453, dtype=F32))

SLOT_COLUMNS = ("key", "key_hash", "size", "ptr", "insert_ts", "last_ts",
                "freq", "ext", "values", "tenant")
SCALARS = ("n_cached", "bytes_cached", "hist_ctr", "clock", "weights",
           "gds_L", "capacity_blocks", "tenant_bytes", "tenant_budget",
           "l0_epoch")
STAT_FIELDS = ("rdma_read", "rdma_write", "rdma_cas", "rdma_faa", "rpc",
               "rdma_read_bytes", "rdma_write_bytes", "gets", "sets", "hits",
               "misses", "hit_bytes", "miss_bytes", "regrets", "evictions",
               "bucket_evictions", "insert_drops", "route_drops",
               "replica_writes", "replica_drops", "fc_hits", "fc_flushes",
               "weight_syncs", "l0_hits", "l0_invalidations")
EXPERTS = ("lru", "lfu")


class Config:
    """The semantic configuration of one pool (or one memory shard)."""

    def __init__(self, n_buckets, assoc, capacity, capacity_blocks=0,
                 hist_len=0, n_samples=5, sample_window=0,
                 experts=EXPERTS, learning_rate=0.1, base_discount=0.005,
                 sync_period=100, fc_size=64, fc_threshold=10,
                 value_words=2, use_sfht=True, use_lwh=True, use_lwu=True,
                 use_fc=True, **_ignored):
        unknown = [e for e in experts if e not in EXPERTS]
        if unknown:
            raise ValueError(f"the reference ranks by {EXPERTS}; got "
                             f"{unknown}")
        self.n_buckets, self.assoc = int(n_buckets), int(assoc)
        self.capacity = int(capacity)
        self.capacity_blocks = int(capacity_blocks)
        self.hist_len = int(hist_len)
        self.n_samples, self.sample_window = int(n_samples), int(sample_window)
        self.experts = tuple(experts)
        self.learning_rate = float(learning_rate)
        self.base_discount = float(base_discount)
        self.sync_period = int(sync_period)
        self.fc_size, self.fc_threshold = int(fc_size), int(fc_threshold)
        self.value_words = int(value_words)
        self.use_sfht, self.use_lwh = bool(use_sfht), bool(use_lwh)
        self.use_lwu, self.use_fc = bool(use_lwu), bool(use_fc)

    @property
    def n_slots(self):
        return self.n_buckets * self.assoc

    @property
    def history_len(self):
        return self.hist_len if self.hist_len > 0 else self.capacity

    @property
    def budget_blocks(self):
        return self.capacity_blocks if self.capacity_blocks > 0 \
            else self.capacity

    @property
    def discount(self):
        return float(self.base_discount) ** (1.0 / float(self.capacity))

    def shard(self, n_shards):
        """The configuration of one of ``n_shards`` memory shards."""
        out = Config(**vars(self))
        out.n_buckets = self.n_buckets // n_shards
        out.capacity = self.capacity // n_shards
        out.capacity_blocks = self.capacity_blocks // n_shards
        out.hist_len = self.history_len // n_shards
        return out


# --------------------------------------------------------------------------
# u32 arithmetic, threefry-2x32, the key hash.
# --------------------------------------------------------------------------

def add32(a, b):
    return (a + b) & M32


def mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl32(x, d):
    return ((x << d) & M32) | (x >> (32 - d))


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x0, x1):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = add32(x0, ks[0])
    x1 = add32(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add32(x0, x1)
            x1 = rotl32(x1, r) ^ x0
        x0 = add32(x0, ks[(i + 1) % 3])
        x1 = add32(add32(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def split_key(seed, n, device):
    """The n lane keys of ``seed``: threefry((0, seed mod 2^32), (0, i))."""
    lo = torch.arange(n, dtype=I64, device=device)
    k = torch.tensor([0, int(seed) & M32], dtype=I64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data):
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & M32)
    return torch.stack([y0, y1], dim=-1)


def uniform2(key):
    """Two uniforms in [0, 1) a key: the 23 high bits of y0 ^ y1 of
    threefry(key, (0, i)), i = 0, 1, as a float's mantissa, minus 1."""
    lo = torch.arange(2, dtype=I64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(F32) - 1.0


def hash_key(key):
    """splitmix32's finalizer on u32 keys."""
    x = add32(key.to(I64) & M32, 0x9E3779B9)
    x = mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


# --------------------------------------------------------------------------
# Ordered float sums.
# --------------------------------------------------------------------------

def seqscan(x, dim=0):
    """Inclusive scan over ``dim``, f32 adds in index order.  On the card
    a scan over a dim with more than one element after it is one
    sequential pass; a lone column is widened to two first."""
    if x.device.type == "cuda":
        if math.prod(x.shape[dim + 1:]) == 1:
            wide = x.unsqueeze(-1).expand(*x.shape, 2)
            return torch.cumsum(wide, dim=dim)[..., 0]
        return torch.cumsum(x, dim=dim)
    rows = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        rows.append(rows[-1] + x.select(dim, i))
    return torch.stack(rows, dim=dim)


def seqsum(x, dim=0):
    return seqscan(x, dim).select(dim, -1)


def ranges32(n):
    """Row ranges of a long reduce: all n rows up to 32; else ceil(n/32)
    ranges, the middle ones of 32 rows, the rest split between the first
    (which takes the odd row) and the last."""
    if n <= 32:
        return [(0, n)]
    k = -(-n // 32)
    mid = 32 * (k - 2)
    first = -(-(n - mid) // 2)
    starts = [0, first] + [first + 32 * i for i in range(1, k - 1)]
    return list(zip(starts, starts[1:] + [n]))


def ranged_sum0(x):
    """Sum over dim 0: each range of :func:`ranges32` in order, then the
    range sums by the same rule, until one range is left."""
    spans = ranges32(x.shape[0])
    if len(spans) == 1:
        return seqsum(x)
    sizes = {b - a for a, b in spans}
    if len(sizes) == 1:
        parts = seqsum(x.reshape(len(spans), sizes.pop(), *x.shape[1:]), 1)
    else:
        parts = torch.stack([seqsum(x[a:b]) for a, b in spans])
    return ranged_sum0(parts)


def seqsum_last(x):
    return seqsum(x.movedim(-1, 0))


def seqcumsum_last(x):
    return seqscan(x.movedim(-1, 0)).movedim(0, -1).contiguous()


# --------------------------------------------------------------------------
# Priorities (lower is evicted first) and the extension metadata.
# --------------------------------------------------------------------------

def exp2(x):
    return torch.exp(LN2_F32 * x)


def priorities(last_ts, freq, experts):
    cols = {"lru": last_ts, "lfu": freq}
    return torch.stack([cols[e] for e in experts], dim=-1)


def update_ext(ext_row, old_last_ts, old_freq, clock):
    clock = clock.to(F32)
    old_last = old_last_ts.to(F32)
    new_freq = old_freq.to(F32) + 1.0
    idx = torch.remainder(new_freq, float(LRUK_K))
    ts0 = torch.where(idx == 0.0, clock, ext_row[..., 0])
    ts1 = torch.where(idx == 1.0, clock, ext_row[..., 1])
    gap = clock - old_last
    crf = 1.0 + ext_row[..., 2] * exp2(-LRFU_LAMBDA * gap)
    return torch.stack([ts0, ts1, crf, gap], dim=-1)


def fresh_ext(clock):
    clock = clock.to(F32)
    zero = torch.zeros_like(clock)
    return torch.stack([clock, zero, zero + 1.0, zero + 2.0 ** 30], dim=-1)


# --------------------------------------------------------------------------
# Small helpers.
# --------------------------------------------------------------------------

def first_index(mask, dim=1):
    return mask.to(torch.int32).argmax(dim=dim)


def pick(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def take_expert(x, e):
    B, N, E = x.shape
    got = torch.gather(x, 2, torch.clamp(e, max=E - 1)[:, None, None]
                       .expand(B, N, 1))[:, :, 0]
    return torch.where((e < E)[:, None], got, float("nan"))


def repeat_rows(x, n):
    return x.unsqueeze(1).expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])


def run_edges(idx, last=False):
    """True at the first (``last``: the last) entry of each distinct
    value, in index order."""
    s, order = torch.sort(idx.to(torch.int32), stable=True)
    edge = torch.ones_like(s, dtype=torch.bool)
    if last:
        edge[:-1] = s[:-1] != s[1:]
    else:
        edge[1:] = s[1:] != s[:-1]
    return torch.empty_like(edge).scatter_(0, order, edge)


def first_winner(x, valid):
    return valid & run_edges(torch.where(valid, x, -1))


def expert_cdf(weights):
    p = weights / torch.clamp(seqsum_last(weights)[..., None], min=1e-30)
    return seqcumsum_last(p)


def apply_penalties(weights, penalties, lam):
    """Multiplicative weights, clamped, then normalised."""
    w = weights * torch.exp(-lam * penalties)
    w = torch.clamp(w, min=1e-4)
    return w / seqsum_last(w)[..., None]


def is_live(size):
    return (size != SIZE_EMPTY) & (size != SIZE_HISTORY)


def write_rows(idx, cols, srcs, mask=None):
    """``col[idx[b]] = src[b]`` for each column where ``0 <= idx[b] < n``
    (and ``mask[b]``); a source is a tensor, a number, or ``(cond, a,
    b)``.  Kept indices are unique, or write equal rows."""
    n, B = cols[0].shape[0], idx.shape[0]
    if B == 0:
        return
    ok = (idx >= 0) & (idx < n)
    if mask is not None:
        ok = ok & mask
    keep = torch.nonzero(ok)[:, 0]
    for col, src in zip(cols, srcs):
        col[idx[keep]] = _source(src, col, B)[keep]


def _source(src, col, B):
    if isinstance(src, tuple):
        cond, a, b = src
        return torch.where(cond.reshape((B,) + (1,) * (col.dim() - 1)),
                           _source(a, col, B), _source(b, col, B))
    if torch.is_tensor(src):
        return src
    return col.new_full((B,) + tuple(col.shape[1:]), src)


# --------------------------------------------------------------------------
# The FC cache.
# --------------------------------------------------------------------------

def fc_round(cfg, cl, slot, clock):
    """One round's freq increments through each lane's FC cache: slot
    i64[C] (-1: none).  Returns (fc columns, emit slot [C, 2], emit delta
    [C, 2], n_faa, n_hit)."""
    active = slot >= 0
    if not cfg.use_fc:
        es = torch.stack([torch.where(active, slot, -1),
                          torch.full_like(slot, -1)], dim=1)
        ed = torch.stack([active.to(I64), torch.zeros_like(slot)], dim=1)
        return {}, es, ed, active.sum(), torch.zeros_like(active.sum())
    fs, fd, fi = cl["fc_slot"], cl["fc_delta"], cl["fc_ins"]
    F = fs.shape[1]
    cols = torch.arange(F, device=slot.device)
    take = lambda x, i: torch.gather(x, 1, i[:, None])[:, 0]  # noqa: E731
    match = (fs == slot[:, None]) & active[:, None]
    hit = match.any(dim=1)
    one_hot = match & (cols[None, :] == first_index(match)[:, None])
    new_delta = (fd + one_hot.to(I64)) & M32
    over = one_hot & (new_delta >= cfg.fc_threshold)
    thr = over.any(dim=1)
    ti = first_index(over)
    e0s = torch.where(thr, take(fs, ti), -1)
    e0d = torch.where(thr, take(new_delta, ti), 0)
    miss = active & ~hit
    empty = fs < 0
    vi = torch.where(empty, -INF, fi.to(F32)).argmin(dim=1)
    evf = miss & ~take(empty, vi)
    e1s = torch.where(evf, take(fs, vi), -1)
    e1d = torch.where(evf, take(new_delta, vi), 0)
    install = miss[:, None] & (cols[None, :] == vi[:, None])
    fs = torch.where(install, slot[:, None], torch.where(over, -1, fs))
    fd = torch.where(install, 1, torch.where(over, 0, new_delta))
    fi = torch.where(install, clock, fi)
    return (dict(fc_slot=fs, fc_delta=fd, fc_ins=fi),
            torch.stack([e0s, e1s], dim=1), torch.stack([e0d, e1d], dim=1),
            thr.sum() + evf.sum(), hit.sum())


def fc_group(cfg, cl, slots, ts):
    """A [G, C] group's freq increments through the FC caches at once:
    each lane's hits on its buffered slots add up, entries that reach the
    threshold flush, each lane's distinct missed slots (first occurrence
    order) take its oldest entries (flushing them), and those beyond its
    F entries flush at once."""
    G, C = slots.shape
    sl = slots.T
    active = sl >= 0
    if not cfg.use_fc:
        return ({}, torch.where(active, sl, -1), active.to(I64),
                active.sum(), torch.zeros_like(active.sum()))
    fs, fd, fi = cl["fc_slot"], cl["fc_delta"], cl["fc_ins"]
    F = fs.shape[1]
    dev = slots.device
    rounds = torch.arange(G, device=dev)
    match = (fs[:, None, :] == sl[:, :, None]) & active[:, :, None]
    fc_hit_r = match.any(dim=2)
    cnt = match.sum(dim=1)
    new_delta = (fd + cnt) & M32
    over = (new_delta >= cfg.fc_threshold) & (cnt > 0)
    flush_slot = torch.where(over, fs, -1)
    flush_delta = torch.where(over, new_delta, 0)
    fs1 = torch.where(over, -1, fs)
    fd1 = torch.where(over, 0, new_delta)
    miss_r = active & ~fc_hit_r
    same = ((sl[:, :, None] == sl[:, None, :]) & miss_r[:, :, None]
            & miss_r[:, None, :])
    earlier = same & (rounds[None, None, :] < rounds[None, :, None])
    first_occ = miss_r & ~earlier.any(dim=2)
    mcount = same.sum(dim=2)
    mrank = torch.cumsum(first_occ.to(I64), dim=1) - 1
    n_miss = first_occ.sum(dim=1)
    empty1 = fs1 < 0
    key = torch.where(empty1, -1.0, fi.to(F32))
    fidx = torch.arange(F, device=dev)
    better = ((key[:, None, :] < key[:, :, None])
              | ((key[:, None, :] == key[:, :, None])
                 & (fidx[None, None, :] < fidx[None, :, None])))
    vrank = better.sum(dim=2)
    installing = vrank < n_miss[:, None]
    ev_flush = installing & ~empty1
    evict_slot = torch.where(ev_flush, fs1, -1)
    evict_delta = torch.where(ev_flush, fd1, 0)
    n_install = torch.clamp(n_miss, max=F)
    overflow = first_occ & (mrank >= n_install[:, None])
    spill_slot = torch.where(overflow, sl, -1)
    spill_delta = torch.where(overflow, mcount, 0)
    sel = (first_occ[:, None, :] & installing[:, :, None]
           & (vrank[:, :, None] == mrank[:, None, :]))
    at = sel.to(torch.int32).argmax(dim=2)
    got = sel.any(dim=2)
    out = dict(fc_slot=torch.where(got, torch.gather(sl, 1, at), fs1),
               fc_delta=torch.where(got, torch.gather(mcount, 1, at), fd1),
               fc_ins=torch.where(got, ts[at], fi))
    n_hit = fc_hit_r.sum() + miss_r.sum() - first_occ.sum()
    n_faa = over.sum() + ev_flush.sum() + overflow.sum()
    return (out, torch.cat([flush_slot, evict_slot, spill_slot], dim=1),
            torch.cat([flush_delta, evict_delta, spill_delta], dim=1),
            n_faa, n_hit)


# --------------------------------------------------------------------------
# State.
# --------------------------------------------------------------------------

def init_state(cfg, device, n_shards=None):
    """An empty pool; with ``n_shards``, the per-shard scalars get a
    leading [n_shards] axis (each shard's budget its share)."""
    n = cfg.n_slots
    z = lambda *s, fill=0: torch.full(s, fill, dtype=I64,  # noqa: E731
                                      device=device)
    st = dict(key=z(n), key_hash=z(n), size=z(n), ptr=z(n), insert_ts=z(n),
              last_ts=z(n), freq=z(n),
              ext=torch.zeros((n, EXT_WIDTH), dtype=F32, device=device),
              values=z(n, cfg.value_words), tenant=z(n),
              bucket_ver=z(cfg.n_buckets))
    E = len(cfg.experts)
    lead = () if n_shards is None else (n_shards,)
    local = cfg if n_shards is None else cfg.shard(n_shards)
    st.update(
        n_cached=z(*lead), bytes_cached=z(*lead), hist_ctr=z(*lead),
        clock=z(*lead, fill=1),
        weights=torch.full(lead + (E,), 1.0 / E, dtype=F32, device=device),
        gds_L=torch.zeros(lead, dtype=F32, device=device),
        capacity_blocks=z(*lead, fill=local.budget_blocks),
        tenant_bytes=z(*lead, 1),
        tenant_budget=z(*lead, 1, fill=local.budget_blocks),
        l0_epoch=z(*lead))
    return st


def init_clients(cfg, n, seed, device):
    E, F = len(cfg.experts), cfg.fc_size
    z = lambda *s, fill=0: torch.full(s, fill, dtype=I64,  # noqa: E731
                                      device=device)
    return dict(
        fc_slot=z(n, F, fill=-1), fc_delta=z(n, F), fc_ins=z(n, F),
        local_weights=torch.full((n, E), 1.0 / E, dtype=F32, device=device),
        penalty_acc=torch.zeros((n, E), dtype=F32, device=device),
        penalty_cnt=z(n), rng=split_key(seed, n, device),
        l0_key=z(n, 0), l0_bkt=z(n, 0), l0_tok=z(n, 0), l0_sz=z(n, 0),
        l0_val=z(n, 0, cfg.value_words), l0_last=z(n, 0),
        l0_seen_epoch=z(n))


def init_stats(device, lead=()):
    return {f: torch.zeros(lead, dtype=I64, device=device)
            for f in STAT_FIELDS}


# --------------------------------------------------------------------------
# The step.
# --------------------------------------------------------------------------

def step(cfg, st, cl, stats, keys, is_write=None, obj_size=None,
         shadow=None):
    """One [G, C] request group against the step-entry table; round r
    runs at time ``clock + r``.  Writes ``st``'s slot columns in place and
    returns (scalars, clients, stats, hit [G, C])."""
    G, C = keys.shape
    B = G * C
    E, K, A = len(cfg.experts), cfg.n_samples, cfg.assoc
    names = cfg.experts
    adaptive = E > 1
    dev = keys.device
    n_slots = cfg.n_slots
    if is_write is None:
        is_write = torch.zeros((G, C), dtype=torch.bool, device=dev)
    if obj_size is None:
        obj_size = torch.ones((G, C), dtype=I64, device=dev)
    values = torch.zeros((B, cfg.value_words), dtype=I64, device=dev)

    keys_b = keys.reshape(B).to(I64)
    op = keys_b != 0
    is_write = is_write.reshape(B)
    obj_size = torch.clamp(obj_size.reshape(B).to(I64), 1, SIZE_HISTORY - 1)
    lane_b = torch.arange(C, device=dev).repeat(G)
    clock = st["clock"]
    ts_round = (clock + torch.arange(G, device=dev)) & M32
    ts_req = ts_round[:, None].expand(G, C).contiguous().reshape(B)

    # 1. Probe the key's bucket (and its embedded history).
    kh = hash_key(keys_b)
    bucket = kh % cfg.n_buckets
    bslots = bucket[:, None] * A + torch.arange(A, device=dev)[None, :]
    b_key, b_size = st["key"][bslots], st["size"][bslots]
    b_hash, b_ptr = st["key_hash"][bslots], st["ptr"][bslots]
    live = is_live(b_size)
    is_hist = b_size == SIZE_HISTORY
    h_age = (st["hist_ctr"] - b_ptr) & M32
    h_valid = is_hist & (h_age < cfg.history_len)
    match = live & (b_key == keys_b[:, None]) & op[:, None]
    found = match.any(dim=1)
    slot = torch.where(found, pick(bslots, first_index(match)), -1)
    h_match = h_valid & (b_hash == kh[:, None]) & op[:, None]
    hist_found = h_match.any(dim=1) & ~found
    hslot = pick(bslots, first_index(h_match))
    regret = hist_found & (adaptive and cfg.use_lwh)
    hit = found
    miss = op & ~found

    # 2. Hit metadata through the FC caches.
    slot_hit = torch.where(hit, slot, -1)
    if G == 1:
        fc, emit_slot, emit_delta, n_faa, n_fc_hit = fc_round(
            cfg, cl, slot_hit, clock)
    else:
        fc, emit_slot, emit_delta, n_faa, n_fc_hit = fc_group(
            cfg, cl, slot_hit.reshape(G, C), ts_round)
    emit_slot = emit_slot.reshape(-1)
    emit_delta = emit_delta.reshape(-1)
    upd_idx = torch.where(hit, slot, n_slots)
    slot0 = torch.clamp(slot, min=0)
    eff = clock.new_zeros((n_slots + 1,)).scatter_reduce(
        0, upd_idx, ts_req, "amax")[slot0]
    hit_last = torch.maximum(st["last_ts"][slot0], eff)
    hit_ext = update_ext(st["ext"][slot0], st["last_ts"][slot0],
                         st["freq"][slot0], eff)

    # 3. Regrets and the lazy expert-weight update.
    hslot0 = torch.clamp(hslot, min=0)
    h_bmap = st["insert_ts"][hslot0]
    h_age_f = ((st["hist_ctr"] - st["ptr"][hslot0]) & M32).to(F32)
    pen = torch.pow(torch.full_like(h_age_f, cfg.discount), h_age_f)
    bits = ((h_bmap[:, None] >> torch.arange(E, device=dev)[None, :])
            & 1).to(F32)
    pen_e = torch.where(regret[:, None], pen[:, None] * bits, 0.0)
    pen_lane = seqsum(pen_e.reshape(G, C, E))[:, None, :]
    reg_lane = regret.reshape(G, C).sum(dim=0)[:, None]
    lam = cfg.learning_rate
    local_w = cl["local_weights"][:, None] * torch.exp(-lam * pen_lane)
    pacc = cl["penalty_acc"][:, None] + pen_lane
    pcnt = cl["penalty_cnt"][:, None] + reg_lane
    syncing = pcnt >= cfg.sync_period if cfg.use_lwu else reg_lane > 0
    tot_pen = ranged_sum0(torch.where(syncing[..., None], pacc, 0.0))
    gw = apply_penalties(st["weights"][None], tot_pen, lam)
    local_w = torch.where(syncing[..., None], gw[None], local_w)
    local_w = torch.clamp(local_w, min=1e-4)
    pacc = torch.where(syncing[..., None], 0.0, pacc)
    pcnt = torch.where(syncing, 0, pcnt)
    n_sync = syncing.sum()
    cdf = expert_cdf(local_w[:, 0])
    u2 = uniform2(fold_in(cl["rng"].repeat(G, 1), ts_req))
    e_choice = (cdf[lane_b] < u2[:, 0][:, None]).sum(dim=-1)

    # 4. Read-through inserts, one a bucket a step.
    want_insert = miss
    winner = first_winner(bucket, want_insert)
    dropped = want_insert & ~winner
    free = (b_size == SIZE_EMPTY) | (is_hist & ~h_valid)
    has_free = free.any(dim=1)
    free_slot = pick(bslots, first_index(free))
    b_prio = take_expert(priorities(
        st["last_ts"][bslots].to(F32), st["freq"][bslots].to(F32), names),
        e_choice)
    b_prio = torch.where(live, b_prio, INF)
    fb_obj_slot = pick(bslots, b_prio.argmin(dim=1))
    fb_hist_slot = pick(bslots, torch.where(h_valid, h_age.to(F32),
                                            -INF).argmax(dim=1))
    has_valid_hist = h_valid.any(dim=1)
    has_live = live.any(dim=1)
    fallback_hist = winner & ~has_free & has_valid_hist
    fallback_obj = winner & ~has_free & ~has_valid_hist & has_live
    plain = winner & has_free
    ins_ok = plain | fallback_hist | fallback_obj
    dropped = dropped | (winner & ~ins_ok)

    # 5. Sampled eviction against the byte budget.
    consumes = plain | fallback_hist
    old_sz = st["size"][slot0]
    set_growth = torch.where(hit & is_write, obj_size - old_sz, 0)
    growing_set = hit & is_write & (set_growth > 0)
    chargers = consumes | growing_set
    n_charge = chargers.sum()
    inc_blocks = torch.where(consumes, obj_size, 0).sum() + set_growth.sum()
    over = st["bytes_cached"] + inc_blocks - st["capacity_blocks"]
    nc = torch.clamp(n_charge, min=1)
    quota = torch.where(over <= 0, 0, torch.clamp((over + nc - 1) // nc,
                                                  min=1))
    must_evict = chargers & (over > 0)
    W = cfg.sample_window or 4 * K
    offs = torch.clamp((u2[:, 1] * n_slots).to(I64), max=n_slots - 1)
    samp = (offs[:, None] + torch.arange(W, device=dev)[None, :]) % n_slots
    s_size = st["size"][samp]
    s_elig = is_live(s_size)
    s_live = s_elig & (torch.cumsum(s_elig.to(I64), dim=1) <= K)
    s_prio = priorities(st["last_ts"][samp].to(F32),
                        st["freq"][samp].to(F32), names)
    s_prio = torch.where(s_live[:, :, None], s_prio, INF)
    cand_slot = torch.gather(samp, 1, s_prio.argmin(dim=1))
    prio_e = take_expert(s_prio, e_choice)
    s_blocks = torch.where(s_live, s_size.to(F32), 0.0)
    cols = torch.arange(W, device=dev)[None, :]
    quota_f = quota.to(F32)
    vs = []
    freed = torch.zeros((B,), dtype=F32, device=dev)
    for _ in range(K):
        arg = prio_e.argmin(dim=1)
        ok = (freed < quota_f) & (pick(prio_e, arg) < INF) & must_evict
        vs.append(torch.where(ok, pick(samp, arg), -1))
        freed = freed + torch.where(ok, pick(s_blocks, arg), 0.0)
        prio_e = torch.where(cols == arg[:, None], INF, prio_e)
    victims_2d = torch.stack(vs, dim=1)
    V = victims_2d.shape[1]
    victims = victims_2d.reshape(-1)
    ev_winner = first_winner(victims, victims >= 0)
    n_evict = ev_winner.sum()
    evicting = must_evict & (victims_2d >= 0).any(dim=1)
    set_ok = hit & is_write
    ins_slot = torch.where(plain, free_slot,
                           torch.where(fallback_hist, fb_hist_slot,
                                       fb_obj_slot))
    cand_rep = repeat_rows(cand_slot, V)
    e_rep = repeat_rows(e_choice, V)
    bmap = ((cand_rep == victims[:, None]).to(I64)
            << torch.arange(E, device=dev)[None, :]).sum(dim=1)
    bmap = bmap | (1 << e_rep)
    write_hist = ev_winner & (adaptive and cfg.use_lwh)
    hist_rank = torch.cumsum(write_hist.to(I64), dim=0) - 1
    hist_ids = (st["hist_ctr"] + hist_rank) & M32
    n_hist = write_hist.sum()
    set_idx = torch.where(set_ok, slot, n_slots)

    # 6. Apply: the hit metadata, the FC flushes, then SET payloads (the
    #    last writer of a slot wins), inserts, evictions, in that order.
    write_rows(upd_idx, (st["last_ts"], st["ext"]), (hit_last, hit_ext))
    st["freq"].index_add_(0, torch.clamp(emit_slot, min=0),
                          torch.where(emit_slot >= 0, emit_delta, 0))
    write_rows(emit_slot, (st["freq"],),
               (st["freq"][torch.clamp(emit_slot, min=0)] & M32,))
    lww = torch.where(run_edges(set_idx, last=True), set_idx, n_slots)
    write_rows(lww, (st["values"], st["size"]), (values, obj_size))
    write_rows(ins_slot, tuple(st[f] for f in SLOT_COLUMNS[:-1]),
               (keys_b, kh, obj_size, 0, ts_req, ts_req, 1,
                fresh_ext(ts_req), values), ins_ok)
    write_rows(victims, (st["size"], st["ptr"], st["insert_ts"]),
               ((write_hist, SIZE_HISTORY, SIZE_EMPTY),
                (write_hist, hist_ids, 0), bmap), ev_winner)
    n_cached = st["n_cached"] + plain.sum() + fallback_hist.sum() - n_evict
    bytes_cached = torch.where(st["size"] == SIZE_HISTORY, 0,
                               st["size"]).sum()
    scalars = dict(n_cached=n_cached, bytes_cached=bytes_cached,
                   hist_ctr=(st["hist_ctr"] + n_hist) & M32,
                   clock=(clock + G) & M32, weights=gw[0],
                   gds_L=st["gds_L"], tenant_bytes=bytes_cached[None])
    new_cl = dict(cl, local_weights=local_w[:, 0], penalty_acc=pacc[:, 0],
                  penalty_cnt=pcnt[:, 0], **fc)

    # 7. The remote-op accounting of the paper's cost model.
    n_op, n_hit, n_miss = op.sum(), hit.sum(), miss.sum()
    n_set = (op & is_write).sum()
    n_ins = ins_ok.sum()
    n_evicting = evicting.sum()
    sf = cfg.use_sfht
    no_sep = cfg.use_lwh or not adaptive
    reads = (n_op + (0 if sf else n_hit) + n_hit
             + (0 if no_sep else n_miss) + n_evicting * (1 if sf else K))
    sep_hist = 0 if no_sep else n_evict
    writes = (n_hit * (1 if sf else 2) + n_ins * 2 + n_hist + sep_hist * 2)
    SLOT_B = 32
    hit_blocks = torch.where(hit, old_sz, 0).sum()
    ins_blocks = torch.where(ins_ok, obj_size, 0).sum()
    set_blocks = torch.where(hit & is_write, obj_size, 0).sum()
    read_b = (n_op * A * SLOT_B + (0 if sf else n_hit * SLOT_B)
              + hit_blocks * 64 + (0 if no_sep else n_miss * SLOT_B)
              + n_evicting * (W if sf else K) * SLOT_B)
    write_b = (n_hit * (SLOT_B // 2 if sf else SLOT_B) + ins_blocks * 64
               + n_ins * SLOT_B + set_blocks * 64 + n_hist * 16
               + sep_hist * SLOT_B)
    if shadow is None:
        sh = torch.zeros_like(op)
    else:
        sh = shadow.reshape(B) & op
    vis = op & ~sh
    sets = (vis & is_write).sum()
    add = dict(
        rdma_read=reads, rdma_write=writes, rdma_cas=n_ins + n_evict,
        rdma_faa=n_faa + n_hist + sep_hist, rpc=n_sync,
        rdma_read_bytes=read_b, rdma_write_bytes=write_b,
        gets=vis.sum() - sets, sets=sets, hits=(hit & ~sh).sum(),
        misses=(miss & ~sh).sum(),
        hit_bytes=torch.where(hit & ~sh, old_sz, 0).sum() * 64,
        miss_bytes=torch.where(miss & ~sh, obj_size, 0).sum() * 64,
        regrets=regret.sum(), evictions=n_evict,
        bucket_evictions=fallback_obj.sum(), insert_drops=dropped.sum(),
        fc_hits=n_fc_hit, fc_flushes=n_faa, weight_syncs=n_sync,
        replica_writes=sh.sum())
    new_stats = dict(stats)
    for k, v in add.items():
        new_stats[k] = stats[k] + v
    return scalars, new_cl, new_stats, hit.reshape(G, C)


def run_groups(cfg, st, cl, stats, keys, is_write):
    """A call's groups, one step each: keys, is_write [NG, G, C].
    ``st`` is written in place.  Returns (clients, stats, hits [NG, G, C],
    weights [NG, E])."""
    hits, weights = [], []
    for g in range(keys.shape[0]):
        sc, cl, stats, hit = step(cfg, st, cl, stats, keys[g], is_write[g])
        st.update(sc)
        hits.append(hit)
        weights.append(st["weights"])
    return cl, stats, torch.stack(hits), torch.stack(weights)
