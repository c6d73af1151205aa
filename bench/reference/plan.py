"""The plain reference of the lane planner, frozen with the benchmark.

A [T, C] trace (T rows of C client lanes) is cut, without reordering,
into maximal runs of consecutive rows such that no lane touches a bucket
twice in a run with a write on either side (repeated reads of a bucket
may share a run) and no run holds more than ``batch`` rows.  Each run
becomes one [batch, C] group, its rows the leading rounds, the rest
padding (key 0).
"""

from __future__ import annotations

import numpy as np


def buckets_of(keys, n_buckets):
    """splitmix32's finalizer of each u32 key, modulo ``n_buckets``."""
    x = keys.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x + np.uint32(0x9E3779B9)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(n_buckets)).astype(np.int64)


def conflict_limits(keys, n_buckets, is_write):
    """i64[T]: for each row, the latest earlier row in which one of its
    lanes touches the same bucket with a write on either side (-1: none).
    A plain double loop over each lane's history of each bucket."""
    T, C = keys.shape
    limit = np.full(T, -1, np.int64)
    bk = buckets_of(keys, n_buckets)
    for c in range(C):
        last_any, last_write = {}, {}
        for t in range(T):
            if keys[t, c] == 0:
                continue
            b = int(bk[t, c])
            w = bool(is_write[t, c])
            prev = last_any.get(b, -1) if w else last_write.get(b, -1)
            limit[t] = max(limit[t], prev)
            last_any[b] = t
            if w:
                last_write[b] = t
    return limit


def pack_rows(keys, n_buckets, batch, is_write):
    """(keys u32[NG, batch, C], is_write bool[NG, batch, C], the source
    row of each cell i32[NG, batch, C], -1 on padding)."""
    keys = np.asarray(keys, np.uint32)
    T, C = keys.shape
    limit = conflict_limits(keys, n_buckets, is_write)
    bounds, s = [], 0
    for t in range(1, T):
        if t - s >= batch or limit[t] >= s:
            bounds.append((s, t))
            s = t
    if T:
        bounds.append((s, T))
    ng = max(len(bounds), 1)
    gk = np.zeros((ng, batch, C), np.uint32)
    gw = np.zeros((ng, batch, C), bool)
    gt = np.full((ng, batch, C), -1, np.int32)
    for i, (s, e) in enumerate(bounds):
        gk[i, :e - s] = keys[s:e]
        gw[i, :e - s] = is_write[s:e]
        gt[i, :e - s] = np.where(keys[s:e] != 0,
                                 np.arange(s, e, dtype=np.int32)[:, None], -1)
    return gk, gw, gt
