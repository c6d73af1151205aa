"""Plain PyTorch versions of the hand-written kernels.

They are the semantics contracts of ``csrc/*.cu``.  The three cache
kernels have the argument contracts of ``repro/kernels/ref.py``: -1
marks a no-op slot, returned slots are taken mod C, and every
argmin/argmax keeps the first index on ties.  Table columns are the cache's own int64 (u32-valued) tensors;
windows index them mod C instead of reading a wrap-padded copy.  The op
wrappers in ``kernels/ops.py`` run these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

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


def access_probe_ref(table_key, table_size, table_hash, table_ptr, keys,
                     hist_ctr, *, assoc: int, history_len: int):
    """Bucket match + embedded-history match.

    Returns (found bool[B], slot i64[B] (-1 miss), hist_found bool[B],
    hist_slot i64[B] (bucket base where nothing matches))."""
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
    age = (hist_ctr - table_ptr[slots]) & M32
    h_match = (sz == 255) & (age < history_len) & (table_hash[slots]
                                                  == kh[:, None])
    hist_found = h_match.any(dim=1) & ~found
    hslot = torch.gather(slots, 1, h_match.to(torch.int32).argmax(
        dim=1, keepdim=True))[:, 0]
    return found, torch.where(found, slot, -1), hist_found, hslot


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
