"""The yardstick's own arithmetic: the frozen generator, the stream, the
tail, the bytes at semantic widths, the trace reduction and the metric
readers, on synthetic inputs."""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.harness import bytes as nbytes
from bench.harness import check, spec
from bench.harness.cell import p95
from bench.harness.trace import summarize
from bench.harness.traffic import Stream, ycsb
from bench.reference.plan import buckets_of


@pytest.mark.parametrize("workload,n_keys,seed,digest,head", [
    ("A", 50_000, 123456789012, "38c208ddc1dd42a1",
     [17113, 20410, 43181, 24861, 47636]),
    ("C", 1_000, 7, "b980b3546022c092", [984, 439, 490, 154, 665]),
])
def test_the_generator_stream_is_fixed_for_a_seed(workload, n_keys, seed,
                                                  digest, head):
    keys, wr = ycsb(workload, 4096, n_keys, 0.99, seed)
    got = hashlib.sha256(keys.tobytes() + wr.tobytes()).hexdigest()[:16]
    assert got == digest and keys[:5].tolist() == head
    assert keys.min() >= 1 and keys.max() <= n_keys
    if workload == "C":
        assert not wr.any()
    else:
        assert 0.45 < wr.mean() < 0.55


def test_the_stream_replays_the_pool_from_a_seeded_row():
    mix = dict(generator="ycsb", workload="A", n_keys=1000, theta=0.99,
               rows_per_call=3, pool_requests=64 * 10)
    a, b = Stream.from_mix(mix, 64, 5), Stream.from_mix(mix, 64, 5)
    assert a.start == b.start
    rows = [a.next()[0] for _ in range(3)]
    assert all(np.array_equal(r, b.next()[0]) for r in rows)
    assert not a.replayed
    rows.append(a.next()[0])
    assert a.replayed
    # 12 rows from the seeded start row of the 10 the pool holds.
    want = a.keys[(a.start + np.arange(12)) % 10]
    assert np.array_equal(np.concatenate(rows), want)


def test_p95_counts_every_request_and_failures_as_infinite():
    calls = [dict(t0=0.0, t1=0.01 * (i + 1), requests=10) for i in range(20)]
    assert p95(calls) == pytest.approx(0.19)
    calls[-1]["failed"] = 10
    assert p95(calls) == pytest.approx(0.19)
    calls[-2]["failed"] = 10
    assert p95(calls) == float("inf")


def _step():
    # Two steps of a [2, 4] group: keys (0 = none), writes, hits.
    keys = np.array([[[5, 6, 0, 7], [5, 9, 9, 0]],
                     [[1, 2, 3, 4], [0, 0, 0, 0]]])
    wr = np.array([[[1, 0, 0, 0], [0, 1, 0, 0]],
                   [[0, 0, 0, 1], [0, 0, 0, 0]]], bool)
    hits = np.array([[[1, 0, 0, 1], [1, 1, 1, 0]],
                     [[0, 0, 0, 1], [0, 0, 0, 0]]], bool)
    counters = dict(misses=4, insert_drops=1, evictions=2, fc_flushes=3)
    return keys, wr, hits, counters


def test_bytes_count_semantic_widths_not_storage():
    keys, wr, hits, counters = _step()
    kw = dict(n_buckets=1 << 20, assoc=8, n_samples=5, n_experts=2,
              value_words=250)
    narrow = nbytes.call_bytes(keys.astype(np.uint32), wr, hits, counters,
                               **kw)
    wide = nbytes.call_bytes(keys.astype(np.int64), wr.astype(np.int64),
                             hits.astype(np.int64), counters, **kw)
    assert narrow == wide
    # Buckets of distinct keys are distinct at 2^20 buckets here.
    buckets = [len(set(buckets_of(k[k != 0], 1 << 20).tolist()))
               for k in keys.reshape(2, -1)]
    assert buckets == [4, 4]
    assert narrow["probe"] == 8 * 8 * 25 + 10 * 9
    # Distinct hit keys a step: {5, 7, 9} and {4}; three FC flushes.
    assert narrow["hit_meta"] == 4 * 44 + 3 * 8
    assert narrow["eviction"] == 2 * (5 * 13 + 8 + 4)
    # SET hits: 5 (step 1), 9 in row 2 lane 1 (step 1), 4 (step 2); a
    # value is 250 u32 words, an insert's slot 41 B and its value.
    assert narrow["apply"] == 3 * 1001 + 3 * 1041 + 2 * 9
    # GET hits: 7 and 5, 9 in row 2 (step 1).
    assert narrow["read"] == 3 * 1000
    assert nbytes.PROBED == 25


def test_roofline_share_reads_nothing_without_time_or_bytes():
    assert nbytes.roofline_share(3.35e12, 2.0) == pytest.approx(50.0)
    assert nbytes.roofline_share(10, 0.0) is None
    assert nbytes.roofline_share(0, 1.0) is None


def test_trace_summary_on_a_synthetic_trace():
    dev = [(10, 20, "void access_probe_kernel<8>(...)"),
           (15, 30, "hmu_init_kernel"), (40, 45, "ranked_eviction_kernel"),
           (50, 60, "Memcpy DtoD (Device -> Device)"),
           (200, 300, "drop_scatter_kernel")]
    host = [(30, 55, "aten::copy_"), (0, 100, "cudaGraphLaunch")]
    t = summarize(dev, host, [(0, 100)])
    assert t["window_s"] == pytest.approx(100e-9)
    # Busy: [10, 30], [40, 45], [50, 60] inside the span.
    assert t["busy_s"] == pytest.approx(35e-9)
    assert t["kernels"] == 4
    assert t["family_s"]["access_probe"] == pytest.approx(10e-9)
    assert t["family_s"]["hit_metadata_update"] == pytest.approx(15e-9)
    assert t["family_s"]["drop_scatter"] == pytest.approx(100e-9)
    # Gaps [60, 100], [0, 10], [30, 40], [45, 50]; a tie in overlap goes
    # to the shorter host event.
    assert [(round(s * 1e9), n) for n, s in t["idle_gaps"]] == [
        (40, "host: cudaGraphLaunch (100% of the gap traced)"),
        (10, "host: cudaGraphLaunch (100% of the gap traced)"),
        (10, "host: aten::copy_ (100% of the gap traced)"),
        (5, "host: aten::copy_ (100% of the gap traced)")]
    t = summarize(dev, [(32, 35, "aten::to")], [(0, 100)])
    assert t["idle_gaps"][2][0] == "host: aten::to (30% of the gap traced)"
    assert summarize(dev, host, []) is None


def _ctx(kind, trace=None):
    calls = [dict(t0=0.0, t1=0.5, requests=100, rows=10, plan_s=0.01,
                  steps=4, step_wall_s=0.4),
             dict(t0=0.5, t1=1.5, requests=100, rows=10, plan_s=0.03,
                  steps=6, step_wall_s=0.8)]
    return SimpleNamespace(kind=kind, calls=calls, window_s=1.5,
                           attempted=200, failed=4,
                           counters=dict(route_drops=4), trace=trace)


def test_metric_readers_on_synthetic_calls():
    read = lambda name, ctx: spec.reader(name)(ctx)  # noqa: E731
    pool = _ctx("pool")
    assert read("plan_ms_per_call", pool) == pytest.approx(20.0)
    assert read("step_us", pool) == pytest.approx(120_000.0)
    for name in ("kernels_per_step", "device_idle_share", "step_roofline",
                 "access_probe_roofline"):
        assert read(name, pool) is None
    trace = dict(busy_s=0.5, window_s=2.0, kernels=800, steps=4,
                 family_s=dict(access_probe=0.1, hit_metadata_update=0.0,
                               ranked_eviction=0.2, drop_scatter=0.1),
                 bytes=dict(probe=3.35e9, hit_meta=0, eviction=6.7e8,
                            apply=0, read=0))
    t = _ctx("pool", trace)
    assert read("kernels_per_step", t) == pytest.approx(200.0)
    # 0.5 s busy in a traced span of 2 s.
    assert read("device_idle_share", t) == pytest.approx(75.0)
    # Busy over the span reads as it is, never clamped: a count that
    # outruns the span shows as a negative share.
    over = _ctx("pool", dict(trace, busy_s=2.5))
    assert read("device_idle_share", over) == pytest.approx(-25.0)
    assert read("access_probe_roofline", t) == pytest.approx(1.0)
    assert read("ranked_eviction_roofline", t) == pytest.approx(0.1)
    assert read("hit_metadata_update_roofline", t) is None
    assert read("drop_scatter_roofline", t) is None
    assert read("step_roofline", t) == pytest.approx(
        100 * 4.02e9 / 3.35e12 / 0.5)


def test_ulp_gap_and_word_counts():
    a = np.array([1.0, -2.0, 0.0, np.nan], np.float32)
    b = a.copy()
    assert check.ulp_gap(a, b) == 0
    b[0] = np.nextafter(np.float32(1.0), np.float32(2.0))
    b[2] = -0.0
    assert check.ulp_gap(a, b) == 1
    assert check.words_differ(np.arange(4), np.arange(4)[::-1]) == 4
    assert check.words_differ(np.arange(4), np.arange(5)) == 5


def test_invariants_see_a_broken_table():
    from bench.reference import cache as ref
    cfg = ref.Config(n_buckets=16, assoc=4, capacity=32)
    st = ref.init_state(cfg, "cpu")
    keys = torch.tensor([[3, 11, 40, 3]])
    ref.step(cfg, st, ref.init_clients(cfg, 4, 1, "cpu"),
             ref.init_stats("cpu"), keys)
    leaves = {f"state.{k}": v for k, v in st.items()}
    leaves["state.n_cached"] = torch.tensor(3)
    leaves["state.bytes_cached"] = torch.tensor(3)
    assert check.invariants(leaves, 16, 4) == 0
    broken = dict(leaves, **{"state.n_cached": torch.tensor(2)})
    assert check.invariants(broken, 16, 4) == 1
    moved = dict(leaves, **{"state.key": torch.roll(st["key"], 4)})
    assert check.invariants(moved, 16, 4) >= 1
