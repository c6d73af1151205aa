"""The comparison that decides ``correct``: what the program produced
against what the plain reference works out from the same requests.

Two numbers are compared, each against its limit:

* ``mismatches``: every exact disagreement, summed over the calls
  checked: cells of the grouped trace (key, write flag, source row)
  unlike the reference planner's (``plan_cells``), requests whose hit
  differs (``hit_flags``), integer words of the table (``table_words``)
  and of the pool's scalars and client lanes (``lane_words``) unlike the
  reference's after the call, ``OpStats`` counters unlike
  (``stat_counters``), and invariants of the program's state at the
  window's close that need no reference (``invariants``: occupancy and
  byte counts against the table, every live key in its own bucket and
  there once, the requests served against the counters);
* ``f32_ulp``: the widest gap in units of the last place between a
  float the program holds or reports and the reference's.

Each part of ``mismatches`` is printed beside it, as detail.
"""

from __future__ import annotations

import numpy as np
import torch

EXACT = ("plan_cells", "hit_flags", "table_words", "lane_words",
         "stat_counters", "invariants")
NUMBERS = EXACT + ("f32_ulp",)


def new_tally() -> dict:
    return {k: 0 for k in NUMBERS}


def merge(tally: dict, part: dict) -> None:
    for k, v in part.items():
        tally[k] = max(tally[k], v) if k == "f32_ulp" else tally[k] + v


def compared(tally: dict) -> dict:
    """The numbers held to limits: ``mismatches`` and ``f32_ulp``."""
    return dict(mismatches=sum(tally[k] for k in EXACT),
                f32_ulp=tally["f32_ulp"])


def ulp_gap(a, b) -> int:
    """The widest distance between two f32 arrays in units of the last
    place (equal NaNs and equal infinities read 0)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32)).reshape(-1)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).reshape(-1)
    if a.shape != b.shape:
        return 2 ** 31
    if a.size == 0:
        return 0
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    gap = np.abs(ia - ib)
    gap = np.where(np.isnan(a) & np.isnan(b), 0, gap)
    return int(gap.max())


def words_differ(a, b) -> int:
    """Elements of two integer arrays that differ (all of the larger one
    when their shapes differ).  Tensors are compared on the device of
    the second, so a state's columns need no trip through the host."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        dev = b.device if torch.is_tensor(b) else a.device
        a, b = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
        if a.shape != b.shape:
            return max(a.numel(), b.numel(), 1)
        return int((a.to(torch.int64) != b.to(torch.int64)).sum())
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int((a.astype(np.int64) != b.astype(np.int64)).sum())


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# Which tally an integer leaf of the state counts in.
TABLE = ("state.key", "state.key_hash", "state.size", "state.ptr",
         "state.insert_ts", "state.last_ts", "state.freq", "state.values",
         "state.tenant", "state.bucket_ver")


def compare_state(got: dict, want: dict) -> dict:
    """Program leaves against the reference's, both keyed ``part.field``
    (``state.``, ``clients.``, ``stats.``)."""
    out = new_tally()
    for k in sorted(set(got) | set(want)):
        if k not in got or k not in want:
            out["lane_words"] += 1
            continue
        g, w = got[k], want[k]
        if g.dtype.is_floating_point or w.dtype.is_floating_point:
            out["f32_ulp"] = max(out["f32_ulp"], ulp_gap(_np(g), _np(w)))
        elif k.startswith("stats."):
            out["stat_counters"] += words_differ(g, w)
        elif k in TABLE:
            out["table_words"] += words_differ(g, w)
        else:
            out["lane_words"] += words_differ(g, w)
    return out


def invariants(state: dict, n_buckets: int, assoc: int,
               n_shards: int = 1) -> int:
    """Broken invariants of a program state (tensors on any device):
    each shard's ``n_cached`` and ``bytes_cached`` against its live slots,
    and every live key hashed to the bucket of its slot and live there
    once."""
    from bench.reference.cache import SIZE_EMPTY, SIZE_HISTORY, hash_key
    size, key = state["state.size"], state["state.key"]
    live = (size != SIZE_EMPTY) & (size != SIZE_HISTORY)
    per = size.shape[0] // n_shards
    bad = 0
    n_cached = state["state.n_cached"].reshape(-1)
    bytes_cached = state["state.bytes_cached"].reshape(-1)
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        bad += int(int(n_cached[s]) != int(live[sl].sum()))
        bad += int(int(bytes_cached[s])
                   != int(torch.where(live[sl], size[sl], 0).sum()))
    # A shard's buckets are its range of the pool's, so a key's home
    # bucket is its hash modulo the pool's bucket count either way.
    slot = torch.arange(size.shape[0], device=size.device)
    home = hash_key(key) % n_buckets
    bad += int((live & (home != slot // assoc)).sum())
    lk = torch.where(live, key, -1).reshape(-1, assoc)
    srt = torch.sort(lk, dim=1).values
    bad += int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
    return bad
