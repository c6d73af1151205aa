"""The port on the card: the CUDA kernels against their plain versions,
whole traces on the card against the same traces on the CPU, and the
LM prefill forward and serving engine on the card against the CPU.

Every test here needs a CUDA device; the ``cuda`` fixture skips it
elsewhere.  Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The file imports no JAX (the card's machine has none, and
``--noconftest`` keeps ``tests/conftest.py`` from importing it): the
CPU run of the port, which ``tests/test_torch_cache.py`` holds against
the JAX package, is the reference here.  Integers are bit-equal; f32
columns within 16 ulp of the CPU run (see ``_same``), and a kernel's
``ext`` output within 2 ulp of its plain version on the card.  The
flash-attention kernel is held to its plain version within 2e-2 in bf16
and 2e-5 in f32, as ``tests/test_kernels.py`` holds the Pallas kernel,
and each of its output rows within a relative L2 error of 2^-7 (bf16)
or 2^-16 (f32) of the plain version's f32 output: about twice the
largest reading on an H100, under a 3% error in a row or bf16 scores.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import CacheConfig, execute, make
from repro_torch.core import cache as t_cache
from repro_torch.core import types as t_types
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.hashing import hash_key
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, forward, init_params
from repro_torch.serve import DecodeEngine
from repro_torch.workloads import gen, plan

EXPERTS = ("lru", "lfu", "fifo", "size", "hyperbolic")
# The kernels of core.access and their launches a cache step: the apply's
# three write groups (SET, insert, evict) are one drop_scatter launch.
CACHE_KERNELS = {"access_probe": 1, "hit_metadata_update": 1,
                 "ranked_eviction": 1, "drop_scatter": 1}
C = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)


def _table(rng, n_buckets, assoc, hist_ctr, history_len):
    n = n_buckets * assoc
    cand = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.int64)
    kh = hash_key(torch.from_numpy(cand)).numpy()
    tk, th = np.zeros(n, np.int64), np.zeros(n, np.int64)
    fill = np.zeros(n_buckets, np.int64)
    for k, h in zip(cand, kh):
        b = int(h % n_buckets)
        if fill[b] < assoc:
            tk[b * assoc + fill[b]], th[b * assoc + fill[b]] = k, h
            fill[b] += 1
    size = np.where(tk != 0, np.where(rng.random(n) < 0.55,
                                      rng.integers(1, 9, n), 255), 0)
    ptr = np.where(size == 255,
                   (hist_ctr - rng.integers(0, 2 * history_len, n)) % 2**32,
                   0)
    return tk, size, th, ptr


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda):
    rng = np.random.default_rng(5)
    n_buckets, assoc, B = 1024, 8, 300
    tk, size, th, ptr = _table(rng, n_buckets, assoc, 3, 500)
    keys = _t(np.concatenate([rng.choice(tk[tk != 0], B - 3), [0, 1, 2]]),
              cuda)
    args = (_t(tk, cuda), _t(size, cuda), _t(th, cuda), _t(ptr, cuda), keys,
            torch.tensor(3, device=cuda))
    ops.reset_launches()
    got = ops.access_probe_op(*args, assoc=assoc, history_len=500)
    want = ref.access_probe_ref(*args, assoc=assoc, history_len=500)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    n = n_buckets * assoc
    freq = _t(rng.integers(0, 99, n), cuda)
    last = _t(rng.integers(0, 999, n), cuda)
    ext = torch.rand(n, 4, device=cuda) * 100
    hit = _t(np.where(rng.random(B) < 0.7, rng.integers(0, n, B), -1), cuda)
    margs = (freq, last, ext, hit, _t(1000 + rng.integers(0, 4, B), cuda),
             hit.clone(), _t(rng.integers(1, 5, B), cuda))
    g = ops.hit_metadata_update_op(*margs)
    w = ref.hit_metadata_update_ref(*margs)
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    np.testing.assert_array_max_ulp(g[2].cpu().numpy(), w[2].cpu().numpy(),
                                    maxulp=2)

    rargs = (_t(size, cuda), _t(rng.integers(0, 999, n), cuda), last, freq,
             _t(rng.integers(0, n, B), cuda), _t(rng.integers(0, 5, B), cuda),
             torch.rand(B, device=cuda) < 0.8, _t(rng.integers(0, 4, B), cuda),
             _t(1000 + rng.integers(0, 4, B), cuda))
    for W, filt in ((20, False), (128, True)):
        kw = dict(window=W, k=5, experts=EXPERTS,
                  tenant=_t(rng.integers(0, 3, n), cuda) if filt else None,
                  tfilt=_t(rng.integers(-1, 3, B), cuda) if filt else None)
        g = ops.ranked_eviction_op(*rargs, **kw)
        w = ref.ranked_eviction_ref(*rargs, **kw)
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])

    # The kernels.ops entry point's own three.
    g = ops.bucket_lookup_op(args[0], args[1], keys, assoc=assoc)
    w = ref.bucket_lookup_ref(args[0], args[1], keys, assoc=assoc)
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert bool(g[0].any())

    for W in (20, 128):   # f32 columns padded at the tail with empty slots
        pad = lambda x: torch.cat([x.float(), x.new_zeros(W).float()])
        offs = np.append(rng.integers(0, n, B - 1), n)   # last: the tail
        sargs = (pad(rargs[0]), pad(rargs[1]), pad(last), pad(freq),
                 _t(offs, cuda), _t(rng.integers(0, 5, B), cuda))
        for clock in (1000.0, torch.tensor(1003.0, device=cuda)):
            kw = dict(window=W, k=5, experts=EXPERTS)
            g = ops.sampled_eviction_op(*sargs, clock, **kw)
            w = ref.sampled_eviction_ref(*sargs, clock, **kw)
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            assert int(g[0][-1]) == -1 and int((g[0] >= 0).sum()) > B // 2

    slots = hit.clone()
    slots[4:9] = 17                     # duplicates, -1 no-ops, past C
    slots[9] = n + 3
    margs = (freq.float(), last.float(), slots,
             torch.rand(B, device=cuda) * 10, 1001.5)
    g = ops.metadata_update_op(*margs)
    again = ops.metadata_update_op(*margs)
    w = ref.metadata_update_ref(*margs)
    for x, y, z in zip(g, again, w):    # the same bits on every launch
        assert torch.equal(x, y) and torch.equal(x, z)
    assert ops.launches() == {"access_probe": 1, "hit_metadata_update": 1,
                              "ranked_eviction": 2, "flash_attention": 0,
                              "sampled_eviction": 4, "bucket_lookup": 1,
                              "metadata_update": 2, "drop_scatter": 0}


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,C,Bh,Be,case", [
    (0, 11, 7, 9, "mixed"), (1, 32, 33, 64, "mixed"), (2, 24, 1, 3, "mixed"),
    (3, 17, 40, 5, "mixed"), (4, 16, 32, 8, "one_slot"),
    (5, 16, 24, 24, "overlap"), (6, 4096, 2048, 10240, "mixed")])
def test_in_place_kernels_match_plain_versions_on_the_card(cuda, seed, C, Bh,
                                                           Be, case):
    """The in-place hit-metadata kernel and drop_scatter, bit-equal to
    their plain versions on copies of the same columns: the CPU tests'
    seeds and shapes (every hit on one slot; flushes on exactly the hit
    slots) and the main path's B = 2048."""
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 2**32 - 64, C, dtype=np.uint64).astype(np.int64)
    freq[:3] = [0, 1, 2**32 - 100]
    last = rng.integers(0, 5000, C)
    ext = rng.uniform(0, 60, (C, 4)).astype(np.float32)
    hit = np.where(rng.random(Bh) < 0.75, rng.integers(0, C, Bh), -1)
    hit[: min(4, Bh)] = hit[0]
    if case == "one_slot":
        hit[:] = 2
    emit = np.where(rng.random(Be) < 0.6, rng.integers(0, C, Be), -1)
    emit[: min(2, Be)] = 3
    if case == "overlap":
        emit = hit.copy()
    delta = np.where(emit >= 0, rng.integers(1, 11, Be), 0)
    args = tuple(_t(a, cuda) for a in (hit, 5000 + rng.integers(0, 8, Bh),
                                       emit, delta))
    cols = (_t(freq, cuda), _t(last, cuda), torch.from_numpy(ext).to(cuda))
    got, want = [tuple(c.clone() for c in cols) for _ in range(2)]
    ops.reset_launches()
    ops.hit_metadata_update_op_(*got, *args)
    ref.hit_metadata_update_ref_(*want, *args)
    assert all(map(_same_bits, got, want))

    # Unique in-range entries, as the step gives them; the rest dropped.
    n_in = min(Bh, C) // 2 + 1
    idx = np.full(Bh, C)
    idx[rng.choice(Bh, n_in, replace=False)] = rng.choice(C, n_in,
                                                          replace=False)
    srcs = (_t(rng.integers(0, 2**32, Bh), cuda), 1,
            torch.from_numpy(rng.random((Bh, 4), np.float32)).to(cuda))
    got, want = [tuple(c.clone() for c in cols) for _ in range(2)]
    ops.drop_scatter_op_(_t(idx, cuda), got, srcs)
    ref.drop_scatter_ref(_t(idx, cuda), want, srcs)
    assert all(map(_same_bits, got, want))
    assert not torch.equal(got[0], cols[0])
    assert ops.launches()["hit_metadata_update"] == 1
    assert ops.launches()["drop_scatter"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 2048])
@pytest.mark.parametrize("assoc", [4, 6, 8, 16, 64])
def test_probe_forms_match_plain_versions_on_the_card(cuda, assoc, B):
    """The probe alone and with the insert path's facts (one tile of
    lanes a key; a 64-slot bucket in two 32-slot chunks), bit-equal to
    the plain version: every expert choice's bucket argmin, E included."""
    rng = np.random.default_rng(assoc * 7 + B)
    n_buckets = max(8, 4096 // assoc)
    tk, size, th, ptr = _table(rng, n_buckets, assoc, 3, 500)
    n = n_buckets * assoc
    size[: 2 * assoc] = 255                    # a bucket or two of history
    size[2 * assoc: 3 * assoc] = rng.integers(1, 9, assoc)  # a full one
    keys = _t(np.where(rng.random(B) < 0.5, rng.choice(tk[tk != 0], B),
                       rng.integers(1, 2**32, B, dtype=np.uint64)), cuda)
    args = (_t(tk, cuda), _t(size, cuda), _t(th, cuda), _t(ptr, cuda), keys,
            torch.tensor(3, device=cuda))
    meta = tuple(_t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
                 for _ in range(2)) + (_t(rng.integers(0, 6, n), cuda),)
    kw = dict(assoc=assoc, history_len=500, meta=meta,
              ts=_t(2**31 + rng.integers(0, 8, B), cuda), experts=EXPERTS)
    ops.reset_launches()
    got = ops.access_probe_op(*args, **kw)
    want = ref.access_probe_ref(*args, **kw)
    for g, w in zip(got[:4] + tuple(got[4]), want[:4] + tuple(want[4])):
        assert torch.equal(g, w)
    alone = ops.access_probe_op(*args, assoc=assoc, history_len=500)
    for g, w in zip(alone, want[:4]):
        assert torch.equal(g, w)
    assert ops.launches()["access_probe"] == 2


def _apply_groups(rng, dev, n, B, K, W=2):
    """The cache step's nine columns (n rows) and its three write groups,
    as a function of the columns they write: SET (last-writer-wins
    indices), inserts (masked, all nine columns) and evictions (B * K
    entries, masked, select sources)."""
    u32 = lambda *shape: _t(rng.integers(0, 2**32, shape), dev)
    cols = (u32(n), u32(n), _t(rng.integers(0, 9, n), dev), u32(n), u32(n),
            u32(n), _t(rng.integers(0, 99, n), dev),
            torch.from_numpy(rng.random((n, 4), np.float32)).to(dev),
            u32(n, W))
    val, sz, ts = u32(B, W), _t(rng.integers(1, 9, B), dev), u32(B)
    set_idx = np.full(B, n)
    m = rng.random(B) < 0.5
    set_idx[m] = rng.choice(n, int(m.sum()), replace=False)
    ins_ok = rng.random(B) < 0.3
    ins_slot = rng.integers(0, n, B)
    ins_slot[ins_ok] = rng.choice(n, int(ins_ok.sum()), replace=False)
    ins_src = (_t(rng.integers(1, 2**32, B), dev), u32(B), sz, 0, ts, ts, 1,
               torch.from_numpy(rng.random((B, 4), np.float32)).to(dev), val)
    victims = np.where(rng.random(B * K) < 0.05,
                       rng.integers(0, n, B * K), -1)
    first = np.unique(victims, return_index=True)[1]
    ev = np.zeros(B * K, bool)
    ev[first] = victims[first] >= 0
    hist = torch.from_numpy(rng.random(B * K) < 0.6).to(dev)
    ev_src = ((hist, 255, 0), (hist, u32(B * K), 0),
              _t(rng.integers(0, 8, B * K), dev))
    args = [_t(a, dev) for a in (set_idx, ins_slot, victims)]
    masks = [torch.from_numpy(a).to(dev) for a in (ins_ok, ev)]

    def groups(c):
        key, kh, size, ptr, ins, last, freq, ext, values = c
        return ((args[0], (values, size), (val, sz)),
                (args[1], c, ins_src, masks[0]),
                (args[2], (size, ptr, ins), ev_src, masks[1]))
    return cols, groups


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 64), (63, 512), (2048, 1 << 21)])
def test_drop_scatter_groups_match_plain_version_on_the_card(cuda, B, n):
    """The apply's three write groups in one launch, bit-equal to the plain
    version group by group on copies of the same columns (the cache
    cell's B = 2048 and B * K = 10,240 eviction entries on a
    2,097,152-row table; collisions across groups included)."""
    rng = np.random.default_rng(B)
    cols, groups = _apply_groups(rng, cuda, n, B, 5)
    got, want = [tuple(c.clone() for c in cols) for _ in range(2)]
    ops.reset_launches()
    ops.drop_scatter_groups_op_(groups(got))
    ref.drop_scatter_groups_ref(groups(want))
    assert all(map(_same_bits, got, want))
    assert not all(map(_same_bits, got, cols))
    assert ops.launches()["drop_scatter"] == (1 if cuda.type == "cuda" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 2048])
@pytest.mark.parametrize("K", [5, 33, 64])
def test_wide_samples_match_plain_versions_on_the_card(cuda, K, B):
    """ranked_eviction and sampled_eviction at K <= 32 (the sample on one
    warp's lanes) and K = 33, 64 (a scratch row, ceil(K / 32) entries a
    lane), bit-equal to their plain versions, with quotas that peel most
    of a wide sample."""
    rng = np.random.default_rng(K + B)
    n, W = 4096, max(20, 2 * K)
    size = _t(rng.choice([0, 1, 2, 3, 8, 255], n), cuda)
    last = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    freq = _t(rng.integers(0, 5, n), cuda)               # priority ties
    ins = _t(rng.integers(0, 999, n), cuda)
    rargs = (size, ins, last, freq, _t(rng.integers(0, n, B), cuda),
             _t(rng.integers(0, 6, B), cuda),             # 5: no expert
             torch.rand(B, device=cuda) < 0.8,
             _t(rng.integers(0, 4 * K, B), cuda),
             _t(1000 + rng.integers(0, 4, B), cuda))
    kw = dict(window=W, k=K, experts=EXPERTS)
    g = ops.ranked_eviction_op(*rargs, **kw)
    w = ref.ranked_eviction_ref(*rargs, **kw)
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert B == 1 or int((g[0] >= 0).sum(dim=1).max()) > min(K, 32) // 2
    pad = lambda x: torch.cat([x.float(), x.new_zeros(W).float()])
    offs = np.append(rng.integers(0, n, B - 1), n)        # last: the tail
    sargs = (pad(size), pad(ins), pad(last), pad(freq), _t(offs, cuda),
             _t(rng.integers(0, 5, B), cuda))
    g = ops.sampled_eviction_op(*sargs, 1000.0, **kw)
    w = ref.sampled_eviction_ref(*sargs, 1000.0, **kw)
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def _ycsb(workload, n, n_keys, seed):
    keys, wr = gen.ycsb(workload, n, n_keys=n_keys, seed=seed)
    return keys, C, wr


def _same(a, b):
    """Integers bit-equal; f32 within 16 ulp: CUDA's expf/powf and the
    CPU's differ by up to 2 ulp a call, and the expert weights compound
    them over every lazy sync of the trace."""
    assert np.array_equal(a.hits, b.hits) and np.array_equal(a.ops, b.ops)
    floats = [(a.weights, b.weights)]
    for part, to_np in (("state", t_types.state_to_numpy),
                        ("clients", t_types.clients_to_numpy),
                        ("stats", t_types.stats_to_numpy)):
        x, y = to_np(getattr(a, part)), to_np(getattr(b, part))
        for f in x:
            if x[f].dtype.kind == "f":
                floats.append((x[f], y[f]))
            else:
                assert np.array_equal(x[f], y[f]), (part, f)
    for x, y in floats:
        np.testing.assert_array_max_ulp(x, y, maxulp=16)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_trace_on_the_card_matches_the_cpu(cuda, backend):
    """A grouped segment then a sequential one, graph-replayed on the
    card, against the eager CPU run of the same trace."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=4,
                      experts=("lru", "lfu", "hyperbolic"), backend=backend)
    keys, wr = gen.interleave(*_ycsb("A", 2400, 400, 4))
    half = keys.shape[0] // 2
    gp = plan.pack_rows(keys[:half], cfg.n_buckets, 8, is_write=wr[:half])
    runs = {}
    for dev in ("cpu", cuda):
        ops.reset_launches()
        r = execute(make(cfg, C, 0, device=dev), keys[:half], plan=gp,
                    is_write=wr[:half])
        r2 = execute(r.cache, keys[half:], plan=None, is_write=wr[half:])
        runs[str(dev)] = (r, r2, ops.launches())
    (a, a2, _), (b, b2, launches) = runs["cpu"], runs[str(cuda)]
    _same(a, b)
    _same(a2, b2)
    assert int(b.stats.evictions) > 0
    # One warm-up step per captured segment, then one launch per replay
    # (the config is this test's alone, so both segments capture).
    steps = 2 + gp.n_groups + (keys.shape[0] - half)
    want = steps if backend == "fused" else 0
    assert launches == {k: want * CACHE_KERNELS.get(k, 0) for k in launches}


@pytest.mark.cuda
def test_wide_sample_trace_on_the_card_matches_the_cpu(cuda):
    """n_samples=33 (the ranked eviction's sample wider than a warp): a
    grouped segment graph-replayed on the card against the CPU run."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, n_samples=33,
                      experts=("lru", "lfu", "hyperbolic"))
    keys, wr = gen.interleave(*_ycsb("A", 2400, 400, 8))
    gp = plan.pack_rows(keys, cfg.n_buckets, 8, is_write=wr)
    runs = [execute(make(cfg, C, 0, device=dev), keys, plan=gp, is_write=wr)
            for dev in ("cpu", cuda)]
    _same(*runs)
    assert int(runs[1].stats.evictions) > 0


@pytest.mark.cuda
def test_execute_leaves_the_callers_state_untouched(cuda):
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96)
    keys, wr = gen.interleave(*_ycsb("C", 640, 300, 1))
    c = make(cfg, C, 0, device=cuda)
    before = t_types.state_to_numpy(c.state)
    r = execute(c, keys, plan=None)
    after = t_types.state_to_numpy(c.state)
    for f in before:
        assert np.array_equal(before[f], after[f]), f
    assert int(r.stats.gets) == int((keys != 0).sum())
    again = execute(c, keys, plan=None)
    assert np.array_equal(r.hits, again.hits)


@pytest.mark.cuda
def test_a_later_run_replays_the_captured_step(cuda):
    """The step is captured once per (config, width, lanes), whatever the
    number of steps: a second, shorter execute() launches each kernel
    once a step with no warm-up step, and from the same start gives the
    same per-round hits."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, fc_threshold=9)
    keys, wr = gen.interleave(*_ycsb("A", 640, 300, 2))
    short = keys.shape[0] // 2
    c = make(cfg, C, 0, device=cuda)
    ops.reset_launches()
    r1 = execute(c, keys, plan=None, is_write=wr)
    first = ops.launches()
    ops.reset_launches()
    r2 = execute(c, keys[:short], plan=None, is_write=wr[:short])
    assert first == {k: (keys.shape[0] + 1) * CACHE_KERNELS.get(k, 0)
                     for k in first}
    assert ops.launches() == {k: short * CACHE_KERNELS.get(k, 0)
                              for k in first}
    assert [w["compiled"] for w in r1.windows + r2.windows] == [True, False]
    assert np.array_equal(r2.hits, r1.hits[:short])


@pytest.mark.cuda
def test_the_captured_step_writes_the_table_in_place(cuda):
    """The captured grouped step runs the in-place step on the graph's
    own carry: each table column it returns is the column it was given,
    so nothing is copied back, and every column keeps its data_ptr from
    replay to replay."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, fc_threshold=7)
    keys, wr = gen.interleave(*_ycsb("A", 1280, 300, 6))
    gp = plan.pack_rows(keys, cfg.n_buckets, 8, is_write=wr)
    seen, real = [], t_cache.access_group_

    def spy(cfg_, st, *a, **kw):
        out = real(cfg_, st, *a, **kw)
        seen.append([(getattr(st, f).data_ptr(), getattr(out[0], f)
                      .data_ptr()) for f in t_cache.WRITTEN])
        return out

    had = set(t_cache._GRAPHS)
    ptrs = []
    with mock.patch.object(t_cache, "access_group_", spy):
        for _ in range(2):
            r = execute(make(cfg, C, 0, device=cuda), keys, plan=gp,
                        is_write=wr)
            (cap,) = [t_cache._GRAPHS[k] for k in set(t_cache._GRAPHS) - had]
            ptrs.append([t.data_ptr() for t in cap.leaves])
            assert int(r.stats.evictions) > 0
    assert len(seen) == 2               # the warm-up and the capture
    assert all(a == b for call in seen for a, b in call)
    assert ptrs[0] == ptrs[1]
    fields = t_types.CacheState._fields
    assert [p for p, _ in seen[1]] == [ptrs[0][fields.index(f)]
                                      for f in t_cache.WRITTEN]


@pytest.mark.cuda
def test_the_fused_step_returns_no_whole_column(cuda):
    """One eager fused step on the card: no operator returns a whole
    column but the two of the bytes_cached reduction (the kernels write
    the table in place through ctypes, not as operators)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    cfg = CacheConfig(n_buckets=1024, assoc=4, capacity=2048)
    n, seen = cfg.n_slots, []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "empty" not in str(func):
                seen.extend(str(func) for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor) and t.dim()
                            and t.shape[0] >= n)
            return out

    st, cl, sa = t_cache.make_cache(cfg, C, 0, cuda)
    keys = _t(np.arange(1, 8 * C + 1).reshape(8, C), cuda)
    t_cache.access_group_(cfg, st, cl, sa, keys)
    with Watch():
        t_cache.access_group_(cfg, st, cl, sa, keys + 1, is_write=keys > 30)
    assert [f.split(".")[1] for f in seen] == ["eq", "where"], seen


@pytest.mark.cuda
def test_fused_and_reference_agree_over_hundreds_of_steps(cuda):
    """A few hundred captured grouped steps on the card under each
    backend: every column bit-equal, f32 ones too (the kernel's ext
    update rounds as the reference backend's PyTorch operators do)."""
    runs = {}
    keys, wr = gen.interleave(*_ycsb("A", 9600, 600, 7))
    for backend in ("fused", "reference"):
        cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=4,
                          experts=("lru", "lfu", "hyperbolic"),
                          backend=backend)
        gp = plan.pack_rows(keys, cfg.n_buckets, 8, is_write=wr)
        runs[backend] = execute(make(cfg, C, 0, device=cuda), keys, plan=gp,
                                is_write=wr)
    a, b = runs["fused"], runs["reference"]
    assert gp.n_groups >= 200 and int(a.stats.evictions) > 0
    assert np.array_equal(a.hits, b.hits) and np.array_equal(a.ops, b.ops)
    for part, to_np in (("state", t_types.state_to_numpy),
                        ("clients", t_types.clients_to_numpy),
                        ("stats", t_types.stats_to_numpy)):
        x, y = to_np(getattr(a, part)), to_np(getattr(b, part))
        for f in x:
            assert x[f].tobytes() == y[f].tobytes(), (part, f)
    assert a.weights.tobytes() == b.weights.tobytes()


FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_ROW_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -16}


def _row_err(got, want32) -> float:
    """The largest relative L2 error of one output row (b, t, h)."""
    d = (got.float() - want32).norm(dim=-1) / want32.norm(dim=-1)
    return float(d.max())


def _held_to_plain(got, q, k, v):
    """got within both bounds of the plain version on q, k, v (which
    computes in f32 and rounds its output to q's dtype)."""
    want32 = ref.flash_attention_ref(q.float(), k, v)
    tol = FLASH_TOL[got.dtype]
    torch.testing.assert_close(got.float(), want32.to(got.dtype).float(),
                               atol=tol, rtol=tol)
    assert _row_err(got, want32) <= FLASH_ROW_TOL[got.dtype]


def _flash_inputs(dev, b, t, h, d, n_rep, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, t, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, t, h // n_rep, d, generator=g, device=dev)
            .to(dtype) for _ in range(2))
    return q, attention.repeat_kv(k, n_rep), attention.repeat_kv(v, n_rep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h,d,n_rep", [
    (1, 1000, 8, 128, 4),     # ragged T, GQA expand view (stride 0)
    (2, 256, 3, 64, 1),
    (1, 130, 2, 32, 2),
    (3, 1, 4, 64, 1),         # one token
    # Head dim 256 (gemma-2b's, MQA at n_rep = 8) and T off the bf16
    # kernel's 128-row query tiles and 128- or 64-key KV tiles.
    (1, 1, 8, 256, 8),
    (1, 127, 8, 256, 8),
    (1, 129, 4, 256, 2),
    (1, 1000, 8, 256, 8),
    (2, 127, 4, 128, 2),
    (1, 129, 2, 64, 1),
])
def test_flash_kernel_matches_its_plain_version(cuda, dtype, b, t, h, d,
                                                n_rep):
    q, k, v = _flash_inputs(cuda, b, t, h, d, n_rep, dtype, seed=t + d)
    ops.reset_launches()
    got = ops.flash_attention_op(q, k, v)
    assert ops.launches()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == (b, t, h, d)
    _held_to_plain(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q and v as transposed [B, H, T, D] storage, k as a slice of a
    wider tensor: the kernel reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, t, h, d = 2, 200, 4, 64
    q = torch.randn(b, h, t, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, h, t, d, generator=g, device=cuda).to(dtype)
    wide = torch.randn(b, t, 2 * h, d, generator=g, device=cuda).to(dtype)
    q, v, k = q.transpose(1, 2), v.transpose(1, 2), wide[:, :, h:]
    got = ops.flash_attention_op(q, k, v)
    _held_to_plain(got, q.contiguous(), k.contiguous(), v.contiguous())


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 2, 16, 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_op(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 64, 2, 72, 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="aligned"):   # 8 bytes in
        ops.flash_attention_op(q[..., 4:68], k[..., 4:68], v[..., 4:68])
    # Layouts a TMA tensor map cannot describe: no fallback takes them.
    q, k, v = _flash_inputs(cuda, 1, 64, 2, 64, 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="tensor map"):   # stride 0 on T
        ops.flash_attention_op(q, k[:, :1].expand_as(k), v)
    wide = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="tensor map"):   # 136-byte heads
        ops.flash_attention_op(q, wide[..., :64], wide[..., :64])


def _card_model():
    """A few-layer smollm-shaped config the kernel takes (head dim 32)."""
    return dataclasses.replace(smoke_config(get_arch("smollm-135m")),
                               n_layers=3, head_dim=32, d_model=96)


@pytest.mark.cuda
def test_prefill_forward_on_the_card_matches_the_cpu(cuda):
    """f32 weights: every layer's attention through the kernel on the
    card against the plain version on the CPU, within 1e-4."""
    cfg = _card_model()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)))
    want = forward(params, cfg, tokens=toks)
    on_card = _to(params, cuda)
    ops.reset_launches()
    got = forward(on_card, cfg, tokens=toks.to(cuda))
    assert ops.launches()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_bf16_prefill_forward_runs_the_tensor_core_kernel(cuda):
    """bf16 weights, the main path's dtype, so every layer launches the
    tensor-core (wgmma) kernel (f32 takes the FMA one).  Each launch
    within both bounds of the plain version on its in-model inputs; the
    hidden states within a relative L2 of 2^-6 of the same forward
    through the plain version (about 0.011 on an H100 for this seed:
    three random layers amplify the bf16 rounding of the attention
    output).  The control, the plain version with every row past the
    first 64 3% off,
    fails the row bound and lands past 2^-6 (0.0216 on the H100)."""
    cfg = _card_model()
    params = init_params(cfg, generator=torch.Generator(device=cuda)
                         .manual_seed(0), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150))).to(cuda)
    kernel, fault_rows = ops.flash_attention_op, []

    def held(q, k, v):
        o = kernel(q, k, v)
        _held_to_plain(o, q, k, v)
        return o

    def shifted(q, k, v):
        o = ref.flash_attention_ref(q, k, v)
        o[:, 64:] = (o[:, 64:].float() * (1 + 2 ** -5)).to(o.dtype)
        fault_rows.append(_row_err(o, ref.flash_attention_ref(q.float(),
                                                              k, v)))
        return o

    hidden = {}
    ops.reset_launches()
    for name, fn in (("kernel", held), ("plain", ref.flash_attention_ref),
                     ("fault", shifted)):
        with mock.patch.object(ops, "flash_attention_op", fn):
            hidden[name] = forward(params, cfg, tokens=toks).float()
    assert ops.launches()["flash_attention"] == cfg.n_layers
    assert min(fault_rows) > FLASH_ROW_TOL[torch.bfloat16]
    base = hidden["plain"].norm()
    rel = {n: float((h - hidden["plain"]).norm() / base)
           for n, h in hidden.items()}
    print(f"hidden states' relative L2 from the plain path: {rel}; "
          f"the control's rows up to {max(fault_rows):.3g}")
    assert rel["kernel"] <= 2 ** -6 < rel["fault"], rel


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda):
    """The engine's greedy tokens and the page cache's decisions on the
    card (its three kernels) equal the CPU run's, in f32."""
    cfg = _card_model()
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    shared = rng.integers(1, cfg.vocab_size, 32).astype(np.uint32)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size, n)])
               .astype(np.uint32) for n in (32, 0, 48, 32, 16)]
    runs = {}
    for dev in ("cpu", cuda):
        eng = DecodeEngine(cfg, _to(params, dev), lanes=2, max_len=96,
                           pool_pages=6)
        for i, p in enumerate(prompts):
            eng.submit(p, 6, rid=i)
        ops.reset_launches()
        done = eng.run()
        runs[str(dev)] = ({r.rid: (r.out, r.pages_skipped) for r in done},
                          int(eng.pagecache.stats.evictions), ops.launches())
    (cpu_out, cpu_ev, _), (card_out, card_ev, launches) = (
        runs["cpu"], runs[str(cuda)])
    assert card_out == cpu_out and card_ev == cpu_ev > 0
    assert min(launches[k] for k in CACHE_KERNELS) > 0
