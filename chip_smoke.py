#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                     # the full run (one card)
    python3 chip_smoke.py --profile 200 --out runs/smoke.json
                                              # + a traced window, saved

``--requests N`` shortens the end-to-end phase; below ~4.5M requests
the table does not fill, and the run fails its eviction check.

Phases, each of which raises (exit code != 0) on any failure:

1. Build: the hand-written CUDA kernels of ``src/repro_torch/kernels/csrc``
   compile with nvcc (one process per source, all at once).
2. Per-kernel check: ``access_probe``, ``hit_metadata_update`` and
   ``ranked_eviction`` against their plain PyTorch versions on the card,
   over a random 2,097,152-slot table made with numpy from a seed, at
   B = 64 and B = 2048 with duplicates, -1 no-ops, history ages that
   wrap, quota > 1 and tenant filters.  Integer outputs must be
   bit-equal; the f32 ``ext`` column within 2 ulp.  Each kernel and its
   plain version are timed with CUDA events at the main path's shapes.
3. End to end, grouped: YCSB-A (50% SET, zipf 0.99) over 10M keys, 64
   client lanes, a 2,097,152-slot cache (capacity 1,048,576 objects),
   planned once at batch 32, through ``execute()`` with the fused and
   the reference backend.  Integer state, OpStats and per-round hits
   must be bit-equal, f32 columns within 4 ulp; every kernel must have
   launched and the cache must have evicted.
4. End to end, sequential: 1,000 more rounds at ``plan=None`` from the
   warmed caches, checked the same way.
5. End to end, adaptive: 2,000 more rounds through ``execute()`` with
   its default plan (``"adaptive"``, a width per 64-row window), from
   the caches phase 4 left, checked the same way.

Launch counts are the kernels' own: each kernel adds one to a counter
on the device, also when its launch is replayed from a CUDA graph; the
counters are set to 0 just before each run of the main path and read
just after it.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
SEED = 0
N_BUCKETS, ASSOC, CAPACITY = 262_144, 8, 1_048_576
LANES, BATCH = 64, 32
N_KEYS = 10_000_000
SEQ_ROUNDS = 1_000
ADAPTIVE_ROWS = 2_000
EXPERTS_ALL = ("lru", "lfu", "fifo", "size", "hyperbolic")


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and comparison helpers.
# ---------------------------------------------------------------------------

def time_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: n calls captured in one CUDA graph and
    replayed reps times between two CUDA events, so the host's launch
    cost is not in the number (the inputs stay in L2 between calls)."""
    import torch
    from repro_torch.core.cache import capture_graph
    graph, _ = capture_graph(lambda: [fn() for _ in range(n)])
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def eager_ms(fn, n: int = 50) -> float:
    """Time of one call launched from Python, host cost included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def ulp_diff(x, y) -> int:
    """Max distance in units of the last place between two f32 arrays."""
    import numpy as np
    xi = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    yi = np.asarray(y, np.float32).view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, -(xi & 0x7FFFFFFF), xi)
    yi = np.where(yi < 0, -(yi & 0x7FFFFFFF), yi)
    return int(np.max(np.abs(xi - yi), initial=0))


def same_int(name, got, want) -> None:
    import torch
    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{name}: {bad} integer elements differ")


def close_f32(name, got, want, maxulp: int) -> float:
    import torch
    d = ulp_diff(got.cpu().numpy(), want.cpu().numpy())
    if d > maxulp:
        raise AssertionError(f"{name}: {d} ulp apart (bound {maxulp})")
    diff = torch.where(got == want, 0.0, got.double() - want.double())
    return float(diff.abs().max()) if got.numel() else 0.0


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on a full-size table.
# ---------------------------------------------------------------------------

def random_table(rng, n_buckets: int, assoc: int, hist_ctr: int,
                 history_len: int):
    """A filled table as numpy int64 columns: live keys in their own
    buckets, history entries (some past history_len, some with ptr ahead
    of hist_ctr, so the age wraps mod 2^32), empty slots."""
    import numpy as np
    from repro_torch.core.hashing import splitmix32
    import torch
    n = n_buckets * assoc
    cand = rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.int64)
    kh = splitmix32(torch.from_numpy(cand)).numpy()
    bucket = kh % n_buckets
    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    first = np.searchsorted(b_sorted, b_sorted, side="left")
    rank = np.arange(n) - first
    keep = rank < assoc
    slot = b_sorted[keep] * assoc + rank[keep]
    key = np.zeros(n, np.int64)
    khash = np.zeros(n, np.int64)
    key[slot] = cand[order][keep]
    khash[slot] = kh[order][keep]
    filled = np.zeros(n, bool)
    filled[slot] = True
    kind = rng.random(n)
    size = np.where(kind < 0.6, rng.integers(1, 9, n), 255)
    size = np.where(filled, size, 0).astype(np.int64)
    age = rng.integers(0, 2 * history_len, n)
    ptr = np.where(size == 255, (hist_ctr - age) % 2**32, 0).astype(np.int64)
    return dict(key=key, key_hash=khash, size=size, ptr=ptr)


def check_kernels(dev, results: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    n_slots = N_BUCKETS * ASSOC
    hist_ctr, history_len = 1_000, CAPACITY
    tab = random_table(rng, N_BUCKETS, ASSOC, hist_ctr, history_len)
    t = {k: torch.from_numpy(v).to(dev) for k, v in tab.items()}
    hctr = torch.tensor(hist_ctr, dtype=torch.int64, device=dev)
    live = np.nonzero((tab["size"] > 0) & (tab["size"] < 255))[0]
    hist = np.nonzero(tab["size"] == 255)[0]
    u32 = lambda m: rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.int64)

    # Metadata columns of the table (u32 values) and ext.
    freq = torch.from_numpy(rng.integers(0, 2**32, n_slots, dtype=np.uint64)
                            .astype(np.int64) % 50_000).to(dev)
    last = torch.from_numpy(rng.integers(0, 2**32, n_slots, dtype=np.uint64)
                            .astype(np.int64) % 1_000_000).to(dev)
    ins = torch.from_numpy(rng.integers(0, 1_000_000, n_slots)).to(dev)
    ext = torch.from_numpy(rng.random((n_slots, 4), np.float32) * 1e5).to(dev)
    tenant = torch.from_numpy(rng.integers(0, 4, n_slots)).to(dev)

    def probe_keys(B):
        # Live keys, keys of history entries (valid or aged out), random
        # misses, duplicates and the no-op key 0.
        u = rng.random(B)
        k = np.where(u < 0.4, tab["key"][rng.choice(live, B)],
                     np.where(u < 0.6, tab["key"][rng.choice(hist, B)],
                              u32(B)))
        k[rng.random(B) < 0.1] = 0
        k[B // 2:B // 2 + 4] = k[0]
        return torch.from_numpy(k).to(dev)

    shapes = {}
    for B in (64, 2048):
        keys = probe_keys(B)
        args = (t["key"], t["size"], t["key_hash"], t["ptr"], keys, hctr)
        kw = dict(assoc=ASSOC, history_len=history_len)
        got = ops.access_probe_op(*args, **kw)
        want = ref.access_probe_ref(*args, **kw)
        for name, g, w in zip(("found", "slot", "hist_found", "hist_slot"),
                              got, want):
            same_int(f"access_probe[B={B}].{name}", g, w)
        if not (bool(got[0].any()) and bool(got[2].any())):
            raise AssertionError("access_probe: no key or history match")
        shapes[("access_probe", B)] = (args, kw)

        # hit_metadata_update: duplicate hits, -1 no-ops, emits with
        # duplicates (the main path's emit width is C * (2F + G)).
        hit = rng.choice(live, B).astype(np.int64)
        hit[rng.random(B) < 0.3] = -1
        hit[1:9] = hit[0] if hit[0] >= 0 else live[0]
        hts = (1_000_000 + rng.integers(0, 32, B)).astype(np.int64)
        Be = LANES * (2 * 64 + BATCH) if B == 2048 else 2 * B
        emit = np.full(Be, -1, np.int64)
        m = rng.random(Be) < 0.05
        emit[m] = rng.choice(live, int(m.sum()))
        emit[:4] = hit[0]
        delta = np.where(emit >= 0, rng.integers(1, 11, Be), 0)
        args = tuple(torch.from_numpy(a).to(dev) for a in (hit, hts, emit,
                                                           delta))
        margs = (freq, last, ext) + args
        got = ops.hit_metadata_update_op(*margs)
        want = ref.hit_metadata_update_ref(*margs)
        same_int(f"hit_metadata_update[B={B}].freq", got[0], want[0])
        same_int(f"hit_metadata_update[B={B}].last_ts", got[1], want[1])
        err = close_f32(f"hit_metadata_update[B={B}].ext", got[2], want[2], 2)
        results.setdefault("hit_metadata_update", {})["max_abs_err"] = max(
            err, results.get("hit_metadata_update", {}).get("max_abs_err", 0))
        shapes[("hit_metadata_update", B)] = (margs, {})

        # ranked_eviction: all five kernel experts, W = 20 and W = 128,
        # per-op quota up to 3, tenant filters; then the main path's form.
        for W, experts, filt in ((20, EXPERTS_ALL, False),
                                 (128, EXPERTS_ALL, True),
                                 (20, ("lru", "lfu"), False)):
            E = len(experts)
            offs = torch.from_numpy(rng.integers(0, n_slots, B)).to(dev)
            ech = torch.from_numpy(rng.integers(0, E, B)).to(dev)
            must = torch.from_numpy(rng.random(B) < 0.8).to(dev)
            quota = torch.from_numpy(rng.integers(0, 4, B)).to(dev)
            ts = torch.from_numpy(1_000_000 + rng.integers(0, 32, B)).to(dev)
            tf = torch.from_numpy(np.where(rng.random(B) < 0.5, -1,
                                           rng.integers(0, 4, B))).to(dev)
            rargs = (t["size"], ins, last, freq, offs, ech, must, quota, ts)
            rkw = dict(window=W, k=5, experts=experts,
                       tenant=tenant if filt else None,
                       tfilt=tf if filt else None)
            got = ops.ranked_eviction_op(*rargs, **rkw)
            want = ref.ranked_eviction_ref(*rargs, **rkw)
            same_int(f"ranked_eviction[B={B},W={W},E={E}].victims",
                     got[0], want[0])
            same_int(f"ranked_eviction[B={B},W={W},E={E}].cand",
                     got[1], want[1])
            if int((got[0] >= 0).sum()) == 0:
                raise AssertionError("ranked_eviction took no victim")
        shapes[("ranked_eviction", B)] = (rargs, rkw)
        log(f"kernels agree with their plain versions at B={B}")

    # Timing at the main path's shape (B = G * C = 2048) on this table.
    torch.cuda.synchronize()
    from repro_torch.kernels.bucket_lookup import access_probe
    from repro_torch.kernels.metadata_update import (
        hit_metadata_update, hit_metadata_update_into)
    from repro_torch.kernels.sampled_eviction import ranked_eviction
    # hit_metadata_update's own passes write into copies of the step-entry
    # columns; the copy is timed and bounded on its own below.
    margs, _ = shapes[("hit_metadata_update", 2048)]
    fresh = tuple(a.clone() for a in margs[:3])
    kern = {"access_probe": (access_probe, ref.access_probe_ref),
            "hit_metadata_update": (
                lambda *a: hit_metadata_update_into(*a, *fresh),
                ref.hit_metadata_update_ref),
            "ranked_eviction": (ranked_eviction, ref.ranked_eviction_ref)}
    for name, (k_fn, p_fn) in kern.items():
        args, kw = shapes[(name, 2048)]
        r = results.setdefault(name, {})
        r["ms"] = time_ms(lambda: k_fn(*args, **kw))
        r["plain_ms"] = time_ms(lambda: p_fn(*args, **kw))
        r["eager_ms"] = eager_ms(lambda: k_fn(*args, **kw))
        r["bytes"] = bound_bytes(name, args, kw)
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r.setdefault("max_abs_err", 0.0)
        log(f"{name} at B=2048: {r['ms'] * 1e3:.2f} us a call on the "
            f"device ({r['eager_ms'] * 1e3:.2f} us launched from Python), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes']} bytes)")
    # The fresh-output copy that hit_metadata_update makes of the three
    # step-entry columns (the eviction reads them after the update): each
    # column read once and written once.
    r = results["hit_metadata_update"]
    r["copy_ms"] = time_ms(lambda: tuple(a.clone() for a in margs[:3]))
    r["copy_bound_ms"] = (2 * sum(a.numel() * a.element_size()
                                  for a in margs[:3]) / HBM_BYTES_PER_S * 1e3)
    r["wrapper_ms"] = time_ms(lambda: hit_metadata_update(*margs))
    log(f"hit_metadata_update's fresh-column copy: {r['copy_ms'] * 1e3:.2f} "
        f"us, bound {r['copy_bound_ms'] * 1e3:.2f} us; copy and passes "
        f"together {r['wrapper_ms'] * 1e3:.2f} us")


def bound_bytes(name: str, args, kw) -> int:
    """Bytes the function must move on these inputs: each input byte it
    needs read once, each output byte written once (int64 storage)."""
    import torch
    if name == "access_probe":
        tkey, tsize, thash, tptr, keys, _ = args
        assoc = kw["assoc"]
        from repro_torch.core.hashing import bucket_of, hash_key
        buckets = torch.unique(bucket_of(hash_key(keys), tkey.shape[0] // assoc))
        B = keys.shape[0]
        return int(buckets.numel() * assoc * 4 * 8 + B * 8 + 8
                   + B * (1 + 8 + 1 + 8))
    if name == "hit_metadata_update":
        # The passes alone: the hit and emit arrays in; at each distinct
        # hit slot its step-entry freq, last_ts and ext in and last_ts,
        # ext out; at each distinct flush slot freq in and out.
        freq, last, ext, hit, hts, emit, delta = args
        hs = torch.unique(hit[hit >= 0]).numel()
        es = torch.unique(emit[emit >= 0]).numel()
        return int((hit.numel() + hts.numel() + emit.numel()
                    + delta.numel()) * 8 + hs * (8 + 8 + 16) + hs * (8 + 16)
                   + es * (8 + 8))
    size, ins, last, freq, offs, ech, must, quota, ts = args
    W, K = kw["window"], kw["k"]
    E = len(kw["experts"])
    C = size.shape[0]
    B = offs.shape[0]
    idx = (offs[:, None] + torch.arange(W, device=offs.device)[None, :]) % C
    s = size[idx]
    elig = (s > 0) & (s < 255)
    cum = torch.cumsum(elig.to(torch.int64), dim=1)
    # Window slots up to the K-th eligible one (size column), and the
    # metadata of each sampled slot.
    scanned = (cum - elig.to(torch.int64)) < K
    sampled = elig & (cum <= K)
    n_scan = torch.unique(idx[scanned]).numel()
    n_samp = torch.unique(idx[sampled]).numel()
    return int(n_scan * 8 + n_samp * 3 * 8 + B * (8 + 8 + 1 + 8 + 8)
               + B * (K + E) * 8)


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path, both backends, bit-compared.
# ---------------------------------------------------------------------------

def compare_runs(tag: str, a, b) -> None:
    """Fused vs reference ExecResults: integers bit-equal, f32 <= 4 ulp."""
    import numpy as np
    import torch
    if not np.array_equal(a.hits, b.hits):
        raise AssertionError(f"{tag}: per-round hits differ")
    if not np.array_equal(a.ops, b.ops):
        raise AssertionError(f"{tag}: per-round ops differ")
    for part in ("state", "clients", "stats"):
        ta, tb = getattr(a, part), getattr(b, part)
        for f in ta._fields:
            x, y = getattr(ta, f), getattr(tb, f)
            if x.dtype.is_floating_point:
                close_f32(f"{tag}.{part}.{f}", x, y, 4)
            else:
                same_int(f"{tag}.{part}.{f}", x, y)
    d = ulp_diff(a.weights, b.weights)
    if d > 4:
        raise AssertionError(f"{tag}: weight trajectories {d} ulp apart")


def check_state(tag: str, res) -> None:
    """The cache's own invariants on the state a run produced."""
    import torch
    st = res.state
    live = (st.size != 0) & (st.size != 255)
    if int(st.n_cached) != int(live.sum()):
        raise AssertionError(f"{tag}: n_cached != live slots")
    if int(st.bytes_cached) != int(torch.where(live, st.size, 0).sum()):
        raise AssertionError(f"{tag}: bytes_cached != sum of live sizes")
    w = st.weights
    if not bool(torch.isfinite(w).all()) or abs(float(w.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"{tag}: expert weights {w.tolist()}")
    if not 0.0 < res.hit_rate < 1.0:
        raise AssertionError(f"{tag}: hit ratio {res.hit_rate}")


def run_main_path(dev, card: str, n_requests: int, seq_rounds: int,
                  results: dict) -> tuple:
    """Phases 3 and 4; returns the run's numbers, the plan and the
    trace it executed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import CacheConfig, execute, make
    from repro_torch.core.types import hit_ratio
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import interleave, ycsb
    from repro_torch.workloads.plan import pack_rows

    t0 = time.perf_counter()
    keys, wr = ycsb("A", n_requests + (seq_rounds + ADAPTIVE_ROWS) * LANES,
                    n_keys=N_KEYS, seed=SEED)
    k2, w2 = interleave(keys, LANES, wr)
    T = n_requests // LANES
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = pack_rows(k2[:T], N_BUCKETS, BATCH, is_write=w2[:T])
    plan_s = time.perf_counter() - t0
    log(f"trace: {T * LANES} requests over {N_KEYS} keys, {LANES} lanes; "
        f"gen {gen_s:.1f} s; lane plan at batch {BATCH}: {gp.n_groups} "
        f"groups, fill {gp.fill:.3f}, plan_s {plan_s:.2f}")

    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY,
                      backend="fused")
    out = dict(requests=int(gp.n_scheduled), groups=gp.n_groups,
               fill=gp.fill, plan_s=plan_s)
    res = {}
    for backend in ("fused", "reference"):
        c = make(dataclasses.replace(cfg, backend=backend), LANES, SEED,
                 device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        r = execute(c, k2[:T], plan=gp, is_write=w2[:T])
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated(dev)
        n = int(r.ops.sum())
        log(f"[{card}] grouped {backend}: {n} requests in {r.wall_s:.2f} s "
            f"= {n / r.wall_s:.0f} requests/s, "
            f"{r.wall_s * 1e6 / gp.n_groups:.0f} us/step, "
            f"hit ratio {hit_ratio(r.stats):.4f}, evictions "
            f"{int(r.stats.evictions)}, peak {peak / 2**20:.0f} MiB, "
            f"launches {launches}")
        check_state(f"grouped/{backend}", r)
        res[backend] = r
        out[backend] = dict(wall_s=r.wall_s, requests_per_s=n / r.wall_s,
                            us_per_step=r.wall_s * 1e6 / gp.n_groups,
                            hit_ratio=hit_ratio(r.stats),
                            evictions=int(r.stats.evictions),
                            peak_mib=peak / 2**20, launches=launches)
    compare_runs("grouped", res["fused"], res["reference"])
    launches = out["fused"]["launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if out["reference"]["launches"] != {k: 0 for k in launches}:
        raise AssertionError("the reference backend launched a kernel")
    for name, n in launches.items():
        results[name]["launches"] = n
    log("grouped: fused == reference (integers bit-equal, f32 <= 4 ulp)")

    # Sequential rounds from the warmed caches.
    seq = {}
    ks, ws = k2[T:T + seq_rounds], w2[T:T + seq_rounds]
    for backend in ("fused", "reference"):
        ops.reset_launches()
        r = execute(res[backend].cache, ks, plan=None, is_write=ws)
        launches = ops.launches()
        n = int(r.ops.sum())
        log(f"[{card}] sequential {backend}: {n} requests in {r.wall_s:.2f} "
            f"s = {n / r.wall_s:.0f} requests/s, "
            f"{r.wall_s * 1e6 / seq_rounds:.0f} us/step, launches {launches}")
        check_state(f"sequential/{backend}", r)
        seq[backend] = r
        out[f"seq_{backend}"] = dict(
            wall_s=r.wall_s, requests_per_s=n / r.wall_s,
            us_per_step=r.wall_s * 1e6 / seq_rounds, launches=launches)
    compare_runs("sequential", seq["fused"], seq["reference"])
    if min(out["seq_fused"]["launches"].values()) <= 0:
        raise AssertionError("a kernel never launched on the sequential path")
    log("sequential: fused == reference (integers bit-equal, f32 <= 4 ulp)")

    # The default plan ("adaptive") from the caches the sequential rounds
    # left: a width per window, one captured graph per width.
    ada = {}
    lo = T + seq_rounds
    ka, wa = k2[lo:lo + ADAPTIVE_ROWS], w2[lo:lo + ADAPTIVE_ROWS]
    for backend in ("fused", "reference"):
        ops.reset_launches()
        r = execute(seq[backend].cache, ka, is_write=wa)
        launches = ops.launches()
        n = int(r.ops.sum())
        widths = sorted({w["width"] for w in r.windows})
        steps = sum(w["n_steps"] for w in r.windows)
        first = sum(w["wall_s"] for w in r.windows if w["compiled"])
        log(f"[{card}] adaptive {backend}: {n} requests in {r.wall_s:.2f} s "
            f"= {n / r.wall_s:.0f} requests/s, {steps} steps, plan_s "
            f"{r.plan_s:.2f}, {len(r.windows)} segments of widths {widths}, "
            f"{sum(w['compiled'] for w in r.windows)} of them first at their "
            f"width ({first:.2f} s, warm-up and capture included), "
            f"launches {launches}")
        check_state(f"adaptive/{backend}", r)
        ada[backend] = r
        out[f"adaptive_{backend}"] = dict(
            wall_s=r.wall_s, requests_per_s=n / r.wall_s, steps=steps,
            plan_s=r.plan_s, segments=len(r.windows), widths=widths,
            first_segments_s=first, launches=launches)
    compare_runs("adaptive", ada["fused"], ada["reference"])
    if min(out["adaptive_fused"]["launches"].values()) <= 0:
        raise AssertionError("a kernel never launched on the adaptive path")
    log("adaptive: fused == reference (integers bit-equal, f32 <= 4 ulp)")
    if out["fused"]["evictions"] <= 0:
        raise AssertionError("the grouped run evicted nothing")
    return out, gp, k2[:T]


# Kernel-name groups for the profile summary (first match wins).
PROFILE_GROUPS = (
    ("hand-written", ("access_probe_kernel", "ranked_eviction_kernel",
                      "init_and_faa_kernel", "combine_kernel",
                      "write_kernel(")),
    ("device copies", ("Memcpy DtoD", "memcpy", "direct_copy_kernel")),
    ("concatenation", ("CatArrayBatchedCopy",)),
    ("bitwise and shifts", ("Bitwise", "shift_kernel")),
    ("integer adds", ("CUDAFunctor_add", "CUDAFunctorOnSelf_add")),
    ("reductions and scans", ("reduce_kernel", "scan", "cumsum")),
    ("gather, scatter, index", ("scatter_gather", "index_elementwise",
                                "index_kernel", "gather")),
    ("fills", ("FillFunctor",)),
)


def profile_steps(dev, card: str, gp, trace, n_groups: int,
                  out_dir: Path | None) -> None:
    """Trace the first n_groups steps of the grouped run under each
    backend with torch.profiler; print where the device time goes (per
    step, and the busy share of the wall) and, given ``out_dir``, write
    the whole kernel table there."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import CacheConfig, execute, make

    sub = gp._replace(keys=gp.keys[:n_groups],
                      is_write=gp.is_write[:n_groups],
                      sizes=gp.sizes[:n_groups], src_t=gp.src_t[:n_groups])
    for backend in ("fused", "reference"):
        cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC,
                          capacity=CAPACITY, backend=backend)
        c = make(cfg, LANES, SEED, device=dev)
        execute(c, trace, plan=sub)                 # build + allocator warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = execute(c, trace, plan=sub)
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0:
                rows.append((t, e.count, e.key))
        rows.sort(reverse=True)
        total = sum(t for t, _, _ in rows)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"profile_{backend}.txt").write_text("".join(
                f"{t:12.1f} us {n:8d} x  {k}\n" for t, n, k in rows))
        log(f"[{card}] profile {backend}: {n_groups} steps, device "
            f"{total / n_groups:.0f} us/step, wall "
            f"{r.wall_s * 1e6 / n_groups:.0f} us/step, device busy "
            f"{total / 1e6 / r.wall_s:.3f} of the wall; top kernels:")
        for t, n, k in rows[:8]:
            log(f"    {t / n_groups:9.1f} us/step  {n // n_groups:5d}/step"
                f"  {k[:90]}")
        cats: dict = {}
        for t, n, k in rows:
            c = next((c for c, keys in PROFILE_GROUPS
                      if any(key in k for key in keys)), "other")
            cats[c] = cats.get(c, 0.0) + t
        log("    by kind, us/step: " + ", ".join(
            f"{c} {t / n_groups:.1f}" for c, t in
            sorted(cats.items(), key=lambda x: -x[1])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=6_000_000)
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", type=int, default=0,
                    help="also trace this many grouped steps per backend")
    a = ap.parse_args()

    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    runtime.lib()
    log(f"built {len(runtime.sources())} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")

    results: dict = {}
    check_kernels(dev, results)
    e2e, plan, trace = run_main_path(dev, card, a.requests, SEQ_ROUNDS,
                                     results)
    if a.profile:
        profile_steps(dev, card, plan, trace, a.profile,
                      Path(a.out).parent if a.out else None)

    replaces = {
        "access_probe": "src/repro/kernels/bucket_lookup.py:171",
        "hit_metadata_update": "src/repro/kernels/metadata_update.py:154",
        "ranked_eviction": "src/repro/kernels/sampled_eviction.py:215"}
    kernels = []
    for name, r in results.items():
        log(f"[{card}] {name}: {r['ms'] * 1e3:.1f} us (bound "
            f"{r['bound_ms'] * 1e3:.2f} us by bytes), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, launches {r['launches']}")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces[name], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None, eager_ms=r["eager_ms"],
            **{k: r[k] for k in ("copy_ms", "copy_bound_ms", "wrapper_ms")
               if k in r}))
    if a.out:
        out = Path(a.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, kernels=kernels, e2e=e2e),
                                  indent=1, default=float))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
