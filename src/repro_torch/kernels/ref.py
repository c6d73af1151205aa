"""Plain PyTorch versions of the hand-written kernels.

They are the semantics contracts of ``csrc/*.cu``.  The cache kernels
have the argument contracts of ``repro/kernels/ref.py``: -1 marks a
no-op slot and every argmin/argmax keeps the first index on ties.  The
three kernels of ``core.access`` take the cache's own int64 (u32-valued)
table columns; their windows index them mod C instead of reading a
wrap-padded copy, and their returned slots are taken mod C.  The three
kernels of the ``kernels.ops`` entry point alone (``sampled_eviction``,
``bucket_lookup``, ``metadata_update``) keep the JAX ops' forms: f32
columns, windows over a tail-padded copy, slots not taken mod C.  The op
wrappers in ``kernels/ops.py`` run these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import bucket_of, hash_key
from repro_torch.core.priority import LRFU_LAMBDA, LRUK_K, exp2
from repro_torch.core.u32 import M32

_INF = float("inf")


def priorities_ref(size, insert_ts, last_ts, freq, clock, experts):
    """Stacked priorities [..., E] of the kernel-supported experts
    (f32 inputs, ``clock`` broadcastable)."""
    out = []
    for e in experts:
        if e == "lru":
            out.append(last_ts)
        elif e == "lfu":
            out.append(freq)
        elif e == "fifo":
            out.append(insert_ts)
        elif e == "size":
            out.append(-size)
        elif e == "hyperbolic":
            out.append(freq / torch.clamp(clock - insert_ts, min=1.0))
        else:
            raise ValueError(e)
    return torch.stack(out, dim=-1)


def _bucket_match(table_key, table_size, keys, assoc: int):
    """The probe's first half: each key's hash, its bucket's slots
    [B, assoc] and their sizes, and the first live slot holding the key
    (found bool[B], slot i64[B], -1 on a miss).  n_buckets is
    floor(C / assoc)."""
    n_buckets = table_key.shape[0] // assoc
    kh = hash_key(keys)
    slots = (bucket_of(kh, n_buckets)[:, None] * assoc
             + torch.arange(assoc, device=keys.device)[None, :])
    sz = table_size[slots]
    live = (sz > 0) & (sz < 255)
    match = live & (table_key[slots] == keys[:, None])
    found = match.any(dim=1)
    slot = torch.gather(slots, 1, match.to(torch.int32).argmax(
        dim=1, keepdim=True))[:, 0]
    return kh, slots, sz, found, torch.where(found, slot, -1)


def bucket_lookup_ref(table_key, table_size, keys, *, assoc: int):
    """Bucket match alone.  Returns (found bool[B], slot i64[B] (-1
    miss))."""
    _, _, _, found, slot = _bucket_match(table_key, table_size, keys, assoc)
    return found, slot


class ProbeFacts(NamedTuple):
    """What the cache step's insert path needs of each probed key's
    bucket, from the probe's own read of it.  A slot that no rule picks
    is the bucket base (the argmin or argmax of a row with no candidate)."""
    key_hash: torch.Tensor   # i64[B] the key's hash (u32)
    bucket: torch.Tensor     # i64[B]
    free_slot: torch.Tensor  # i64[B] first empty or aged-out history slot
    has_free: torch.Tensor   # bool[B]
    hist_slot: torch.Tensor  # i64[B] oldest valid history entry
    has_hist: torch.Tensor   # bool[B] a valid history entry exists
    has_live: torch.Tensor   # bool[B]
    cand: torch.Tensor       # i64[B, E + 1]: each expert's argmin over the
    #                          live slots; [:, E] the first live slot


def _pick(slots, pos):
    return torch.gather(slots, 1, pos[:, None])[:, 0]


def access_probe_ref(table_key, table_size, table_hash, table_ptr, keys,
                     hist_ctr, *, assoc: int, history_len: int, meta=None,
                     ts=None, experts=None):
    """Bucket match + embedded-history match.

    Returns (found bool[B], slot i64[B] (-1 miss), hist_found bool[B],
    hist_slot i64[B] (bucket base where nothing matches)).  Given
    ``meta``, the table's (insert_ts, last_ts, freq) columns, with each
    op's timestamp ``ts`` i64[B] and the ``experts``, also the bucket's
    :class:`ProbeFacts`, ranked as the cache step's insert path ranks
    them (``core/cache.py``, the JAX package's ``cache.py:396-413``): an
    expert's argmin over the live slots at the op's ``ts``, and the
    argmin at an expert choice of E, where the gather of a missing
    expert reads NaN and argmin takes the first NaN."""
    kh, slots, sz, found, slot = _bucket_match(table_key, table_size, keys,
                                               assoc)
    age = (hist_ctr - table_ptr[slots]) & M32
    is_hist = sz == 255
    h_valid = is_hist & (age < history_len)
    h_match = h_valid & (table_hash[slots] == kh[:, None])
    hist_found = h_match.any(dim=1) & ~found
    hslot = _pick(slots, h_match.to(torch.int32).argmax(dim=1))
    out = (found, slot, hist_found, hslot)
    if meta is None:
        return out
    live = (sz > 0) & (sz < 255)
    free = (sz == 0) | (is_hist & ~h_valid)
    ins, last, freq = (m[slots].to(torch.float32) for m in meta)
    pr = priorities_ref(sz.to(torch.float32), ins, last, freq,
                        ts.to(torch.float32)[:, None], experts)  # [B, A, E]
    pr = torch.cat([pr, torch.full_like(pr[..., :1], float("nan"))], dim=-1)
    pr = torch.where(live[..., None], pr, _INF)
    cand = torch.gather(slots, 1, pr.argmin(dim=1))              # [B, E + 1]
    h_age = torch.where(h_valid, age.to(torch.float32), -_INF)
    return out + (ProbeFacts(
        key_hash=kh, bucket=slots[:, 0] // assoc,
        free_slot=_pick(slots, free.to(torch.int32).argmax(dim=1)),
        has_free=free.any(dim=1), hist_slot=_pick(slots, h_age.argmax(dim=1)),
        has_hist=h_valid.any(dim=1), has_live=live.any(dim=1), cand=cand),)


def hit_metadata_update_ref(freq, last_ts, ext, hit_slots, hit_ts,
                            emit_slots, emit_deltas):
    """Hit-side metadata update into fresh tensors.

    ``last_ts[s] = max(last_ts[s], ts_eff)`` and the extension columns at
    hit slots, where ``ts_eff`` is the max hit timestamp on ``s`` and the
    extension update reads the step-entry ``freq``/``last_ts``/``ext``;
    ``freq[s] += delta`` at FC-flush slots (u32 wrap)."""
    n = freq.shape[0]
    hidx = torch.where(hit_slots >= 0, hit_slots, n)
    eidx = torch.where(emit_slots >= 0, emit_slots, n)
    pad = freq.new_zeros((n + 1,))
    freq2 = (freq + pad.index_add(0, eidx, emit_deltas)[:n]) & M32
    ts_eff = pad.scatter_reduce(0, hidx, hit_ts, "amax")[:n]
    touched = torch.zeros((n + 1,), dtype=torch.bool,
                          device=freq.device).index_fill(0, hidx, True)[:n]
    last2 = torch.where(touched, torch.maximum(last_ts, ts_eff), last_ts)
    clock_f = ts_eff.to(torch.float32)
    widx = torch.remainder(freq.to(torch.float32) + 1.0, float(LRUK_K))
    ts0 = torch.where(widx == 0.0, clock_f, ext[:, 0])
    ts1 = torch.where(widx == 1.0, clock_f, ext[:, 1])
    gap = clock_f - last_ts.to(torch.float32)
    crf = 1.0 + ext[:, 2] * exp2(-LRFU_LAMBDA * gap)
    new_ext = torch.stack([ts0, ts1, crf, gap], dim=-1)
    ext2 = torch.where(touched[:, None], new_ext, ext)
    return freq2, last2, ext2


def hit_metadata_update_ref_(freq, last_ts, ext, hit_slots, hit_ts,
                             emit_slots, emit_deltas) -> None:
    """:func:`hit_metadata_update_ref` in place: ``freq``, ``last_ts`` and
    ``ext`` take its results."""
    for col, new in zip((freq, last_ts, ext), hit_metadata_update_ref(
            freq, last_ts, ext, hit_slots, hit_ts, emit_slots, emit_deltas)):
        col.copy_(new)


def _source(src, col, B: int) -> torch.Tensor:
    """A drop_scatter source as a [B, ...] tensor of the column's dtype:
    a tensor as it is, a number in every row, and ``(cond, a, b)`` as
    ``a`` where ``cond`` holds, else ``b``."""
    if isinstance(src, tuple):
        cond, a, b = src
        return torch.where(cond.reshape((B,) + (1,) * (col.dim() - 1)),
                           _source(a, col, B), _source(b, col, B))
    if torch.is_tensor(src):
        return src
    return col.new_full((B,) + tuple(col.shape[1:]), src)


def drop_scatter_ref(idx, cols, srcs, mask=None) -> None:
    """In place, for each column: ``col[idx[b]] = src[b]`` (see
    :func:`_source`) where ``0 <= idx[b] < n``, the columns' common
    length, and ``mask[b]`` (if given); other entries write nothing.
    In-range kept indices are unique, or their entries write equal rows.

    No host sync, so a CUDA graph can hold it: a dropped entry repeats
    the first kept entry's write, or, where none is kept, writes row 0's
    own value back."""
    n, B = cols[0].shape[0], idx.shape[0]
    if B == 0:
        return
    ok = (idx >= 0) & (idx < n)
    if mask is not None:
        ok = ok & mask
    # [1]-shaped gathers: a 0-d index tensor would be read on the host.
    j = ok.to(torch.int32).argmax().reshape(1)
    any_ok = ok.index_select(0, j)
    tgt = torch.where(ok, idx, torch.where(any_ok, idx.index_select(0, j), 0))
    for col, src in zip(cols, srcs):
        src = _source(src, col, B)
        row = (1,) * (col.dim() - 1)
        keep = torch.where(any_ok.reshape((1,) + row),
                           src.index_select(0, j), col[:1])
        col[tgt] = torch.where(ok.reshape((B,) + row), src, keep)


def drop_scatter_groups_ref(groups) -> None:
    """:func:`drop_scatter_ref` for each group ``(idx, cols, srcs)`` or
    ``(idx, cols, srcs, mask)``, in order: a later group's write of a
    row wins."""
    for g in groups:
        drop_scatter_ref(*g)


def metadata_update_ref(freq, last_ts, slots, deltas, clock):
    """Combining metadata update into fresh f32 tensors: at every slot s
    named by an entry with 0 <= s < C, ``freq[s] += Σ deltas`` and
    ``last_ts[s] = max(last_ts[s], clock)`` (also where the delta is 0);
    other entries (-1 marks a no-op) change nothing.

    A slot's deltas are added one by one in batch order, ``freq + d_1 +
    d_2 + ...``, on any device: the kernel adds in the same order, so the
    two agree bit for bit on any deltas.  The loop runs once per rank of
    an entry among its slot's entries (a host sync reads the most
    entries on one slot)."""
    n = freq.shape[0]
    clock = torch.as_tensor(clock, dtype=torch.float32, device=freq.device)
    pos = torch.nonzero((slots >= 0) & (slots < n))[:, 0]
    s, order = torch.sort(slots[pos], stable=True)
    d = deltas[pos][order]
    # Rank of each entry among its slot's entries, in batch order.
    i = torch.arange(s.shape[0], device=s.device)
    head = torch.ones_like(s, dtype=torch.bool)
    head[1:] = s[1:] != s[:-1]
    rank = i - torch.cummax(torch.where(head, i, 0), dim=0).values
    freq2 = freq.clone()
    for r in range(int(rank.max()) + 1 if s.numel() else 0):
        at = rank == r
        freq2[s[at]] = freq2[s[at]] + d[at]
    last2 = last_ts.clone()
    last2[s] = torch.maximum(last_ts[s], clock)
    return freq2, last2


def sampled_eviction_ref(size, insert_ts, last_ts, freq, offsets, e_choice,
                         clock, *, window: int, k: int, experts):
    """Single-victim sampled eviction at one scalar clock.

    The columns are f32[N], N = C + window, padded at the tail with empty
    slots by the caller; op b's window is positions ``offsets[b] + j``,
    j < window (not mod C; a position outside [0, N) reads as an empty
    slot).  Its sample is the first ``k`` live slots (0 < size < 255);
    every expert's argmin over the sample, at ``clock``, is its
    candidate, -1 for every expert when the sample is empty.  The victim
    is the candidate of expert ``e_choice[b]``, -1 for a choice outside
    [0, E).

    Returns victim i64[B], cand i64[B, E] (window positions)."""
    N = size.shape[0]
    E = len(experts)
    dev = offsets.device
    clock = torch.as_tensor(clock, dtype=torch.float32, device=dev)
    idx = offsets[:, None] + torch.arange(window, device=dev)[None, :]
    inside = (idx >= 0) & (idx < N)
    at = idx.clamp(0, max(N - 1, 0))
    s = torch.where(inside, size[at], 0.0)
    live = (s > 0) & (s < 255)
    in_sample = live & (torch.cumsum(live.to(torch.int64), dim=1) <= k)
    pr = priorities_ref(s, insert_ts[at], last_ts[at], freq[at], clock,
                        experts)                                 # [B, W, E]
    pr = torch.where(in_sample[..., None], pr, _INF)
    cand = torch.gather(idx, 1, pr.argmin(dim=1))                 # [B, E]
    cand = torch.where(in_sample.any(dim=1, keepdim=True), cand, -1)
    ok = (e_choice >= 0) & (e_choice < E)
    victim = torch.gather(cand, 1, e_choice.clamp(0, E - 1)[:, None])[:, 0]
    return torch.where(ok, victim, -1), cand


def ranked_eviction_ref(size, insert_ts, last_ts, freq, offsets, e_choice,
                        must_evict, quota, ts, *, window: int, k: int,
                        experts, tenant=None, tfilt=None):
    """Sampled, expert-ranked eviction decision per op.

    The window of op b is slots ``(offsets[b] + j) mod C``, j < window;
    its sample is the first ``k`` live slots (of tenant ``tfilt[b]`` when
    that is >= 0).  Every expert's argmin over the sample is its
    candidate; the chosen expert's ranking is peeled, lowest priority
    first, while the blocks freed so far fall short of ``quota`` (i64[B]
    or a scalar) and ``must_evict`` holds, at most ``k`` victims.  Priorities are
    evaluated at each op's timestamp ``ts`` (u32).  An ``e_choice``
    outside [0, E) takes no victim: the reference backend's gather of a
    missing expert reads NaN, which never ranks below infinity.

    Returns victims i64[B, k] (-1 where not taken), cand i64[B, E]."""
    C = size.shape[0]
    B = offsets.shape[0]
    E = len(experts)
    dev = offsets.device
    idx = (offsets[:, None]
           + torch.arange(window, device=dev)[None, :]) % C      # [B, W]
    s = size[idx]
    live = (s > 0) & (s < 255)
    if tenant is not None and tfilt is not None:
        live = live & ((tfilt[:, None] < 0) | (tenant[idx] == tfilt[:, None]))
    in_sample = live & (torch.cumsum(live.to(torch.int64), dim=1) <= k)
    s_f = s.to(torch.float32)
    pr = priorities_ref(s_f, insert_ts[idx].to(torch.float32),
                        last_ts[idx].to(torch.float32),
                        freq[idx].to(torch.float32),
                        ts.to(torch.float32)[:, None], experts)  # [B, W, E]
    pr = torch.where(in_sample[..., None], pr, _INF)
    cand = torch.gather(idx, 1, pr.argmin(dim=1))                 # [B, E]

    ok_choice = (e_choice >= 0) & (e_choice < E)
    pr_sel = torch.gather(pr, 2, torch.clamp(e_choice, 0, E - 1)[:, None, None]
                          .expand(B, window, 1))[:, :, 0]
    pr_sel = torch.where(ok_choice[:, None], pr_sel, float("nan"))
    order = torch.argsort(pr_sel, dim=1, stable=True)
    ranked_idx = torch.gather(idx, 1, order)
    ranked_live = torch.gather(in_sample & ok_choice[:, None], 1, order)
    ranked_blocks = torch.where(ranked_live, torch.gather(s_f, 1, order), 0.0)
    freed_before = torch.cumsum(ranked_blocks, dim=1) - ranked_blocks
    quota_f = quota.to(torch.float32).expand(B)
    take = ((freed_before < quota_f[:, None]) & ranked_live
            & must_evict[:, None])
    victims = torch.where(take, ranked_idx, -1)[:, :k]
    return victims, cand


def gqa_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] as given, or the GQA view [B, S, Hkv, R, D] that
    ``models/attention.py::repeat_kv`` makes, as [B, S, Hkv*R, D] (a
    copy: no strided 4-D view of it exists)."""
    return x.flatten(2, 3) if x.dim() == 5 else x


def flash_attention_ref(q, k, v, *, max_score_bytes: int = 1 << 30):
    """Causal softmax attention, forward: q [B, T, H, D]; k and v
    [B, T, H, D] or the GQA view [B, T, Hkv, R, D] (Hkv*R == H).

    Scale ``D**-0.5``; scores, softmax and the weighted sum of values in
    f32 (bf16 products are exact in f32); output in q's dtype.  Each
    query row sees its whole causal score row, two-pass.  Rows go in
    blocks sized so that one block's scores take at most
    ``max_score_bytes``, so a check at T = 32k needs no [T, T] matrix."""
    k, v = gqa_heads(k), gqa_heads(v)
    b, t, h, d = q.shape
    scale = d ** -0.5
    out = torch.empty_like(q)
    rows = max(1, min(t, max_score_bytes // (4 * b * h * t)))
    pos = torch.arange(t, device=q.device)
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        s = torch.einsum("bthd,bshd->bhts", q[:, r0:r1].float(),
                         k[:, :r1].float()) * scale
        s = s.masked_fill(pos[None, :r1] > pos[r0:r1, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, r0:r1] = torch.einsum("bhts,bshd->bthd", p,
                                     v[:, :r1].float()).to(q.dtype)
    return out
