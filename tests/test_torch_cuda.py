"""The port on the card: the CUDA kernels against their plain versions,
whole traces on the card against the same traces on the CPU (single-
pool, multi-tenant and with the L0 tier), and the LM prefill forward and
serving engine on the card against the CPU.

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

from repro_torch.core import CacheConfig, ExecConfig, execute, make
from repro_torch.core import cache as t_cache
from repro_torch.core import spans
from repro_torch.core import types as t_types
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.hashing import hash_key
from repro_torch.kernels import ops, ref
from repro_torch.kernels.metadata_update import TILE, metadata_update_into
from repro_torch.models import attention, forward, init_params
from repro_torch.serve import DecodeEngine
from repro_torch.workloads import gen, plan

EXPERTS = ("lru", "lfu", "fifo", "size", "hyperbolic")
# The kernels of core.access and their launches a cache step: the apply's
# three write groups (SET, insert, evict) are one drop_scatter launch.
CACHE_KERNELS = {"access_probe": 1, "hit_metadata_update": 1,
                 "ranked_eviction": 1, "drop_scatter": 1}
C = 8


def _keep(cfg) -> ExecConfig:
    """``cfg``'s execution knobs with donation off: the call copies the
    handle it is given, which the test reads again."""
    return dataclasses.replace(cfg.split()[1], donate=False)


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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 2048])
@pytest.mark.parametrize("assoc", [1, 4, 6, 8, 16, 64])
def test_bucket_lookup_matches_plain_version_on_the_card(cuda, assoc, B):
    """One tile of lanes a key (a 64-slot bucket in two 32-slot chunks) on
    a table whose last assoc - 1 slots are a ragged tail that no bucket
    covers (C not a multiple of assoc; its keys must miss): bit-equal to
    the plain version, one launch a call."""
    rng = np.random.default_rng(assoc * 11 + B)
    tk, size, _, _ = _table(rng, max(16, 4096 // assoc), assoc, 3, 500)
    tail = assoc - 1
    tk = np.concatenate([tk, rng.integers(1, 2**32, tail, dtype=np.uint64)
                         .astype(np.int64)])
    size = np.concatenate([size, np.full(tail, 3)])
    held = np.nonzero(size > 0)[0]             # live, history, tail
    q = np.where(rng.random(B) < 0.6, tk[rng.choice(held, B)],
                 rng.integers(1, 2**32, B, dtype=np.uint64).astype(np.int64))
    q[-1] = tk[-1]
    args = (_t(tk, cuda), _t(size, cuda), _t(q, cuda))
    ops.reset_launches()
    got = ops.bucket_lookup_op(*args, assoc=assoc)
    want = ref.bucket_lookup_ref(*args, assoc=assoc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert B == 1 or bool(got[0].any())
    assert ops.launches()["bucket_lookup"] == 1


def _md_slots(rng, case, B, C, tile):
    """metadata_update's slots i64[B] of one case on a C-slot table cut
    into tiles of ``tile`` slots (as chip_smoke.py::md_slots)."""
    lo = tile * ((C // tile) // 2)             # a tile in the middle
    span = min(tile, C - lo)
    if case == "one_slot":
        return np.full(B, lo + 5, np.int64)
    if case == "pairs":                        # every slot twice, B / 2 apart
        return np.tile(rng.choice(C, (B + 1) // 2, replace=False), 2)[:B]
    if case == "one_tile":                     # distinct while B fits
        return lo + rng.choice(span, B, replace=B > span)
    if case == "tile_edges":                   # both sides of every edge
        edges = np.arange(tile, C, tile)
        return rng.choice(np.concatenate([edges - 1, edges, [0, C - 1]]), B)
    s = rng.integers(0, C, B)
    if case == "no_ops":                       # -1 and past the table
        bad = rng.random(B) < 0.5
        s[bad] = rng.choice(np.array([-1, C, C + 7, 2**40]), int(bad.sum()))
    else:                                      # mixed
        s = rng.integers(-1, C + 3, B)
        s[1:5] = s[0]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_slot", "pairs", "one_tile",
                                  "tile_edges", "no_ops", "mixed"])
@pytest.mark.parametrize("B", [1, 63, 2048, 65_536])
def test_metadata_update_matches_plain_version_on_the_card(cuda, B, case):
    """The one-launch metadata_update, bit-equal to its plain version,
    where the slots fall against the kernel's tiles (one slot; every slot
    twice, B / 2 apart; distinct slots of one tile; both sides of the
    tile edges; -1 and past-C no-ops; a mix), on a table whose C is not a
    multiple of the tile, once 16-byte aligned and once 4 bytes past (the
    copy's float-at-a-time path), with non-integer deltas and a NaN in
    last_ts: into fresh outputs, in place (the outputs are the inputs'
    own storage), and a second launch the same bits.  One launch a call."""
    rng = np.random.default_rng(B + len(case))
    C = 4 * TILE + 777
    clock = torch.tensor(1_000_016.5, device=cuda)
    ops.reset_launches()
    for off in (0, 1):
        s = _md_slots(rng, case, B, C, TILE)
        f_base = torch.from_numpy(rng.integers(0, 50_000, C + 1).astype(
            np.float32) + rng.random(C + 1, np.float32)).to(cuda)
        l_base = torch.from_numpy(rng.integers(0, 10**6, C + 1).astype(
            np.float32)).to(cuda)
        nan = s[[0, B // 2]]
        l_base[_t(off + nan[(nan >= 0) & (nan < C)], cuda)] = float("nan")
        freq, last = f_base[off:off + C], l_base[off:off + C]
        args = (freq, last, _t(s, cuda),
                torch.from_numpy(rng.random(B, np.float32) * 10).to(cuda),
                clock)
        want = ref.metadata_update_ref(*args)
        got = ops.metadata_update_op(*args)
        again = ops.metadata_update_op(*args[:4], 1_000_016.5)
        own = (f_base.clone()[off:off + C], l_base.clone()[off:off + C])
        metadata_update_into(*own, *args[2:], *own)
        for out in (got, again, own):
            assert all(map(_same_bits, out, want))
        assert B == 1 or not torch.equal(got[0], freq)
    assert ops.launches()["metadata_update"] == 6


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


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 2, 5])
@pytest.mark.parametrize("B", [1, 63, 2048])
@pytest.mark.parametrize("K", [5, 33, 64])
def test_eviction_kernels_match_plain_versions_at_every_expert_count(
        cuda, K, B, E):
    """The ranked eviction's draw form (the fused step's: the threefry
    draw, the expert choice and the victims' bitmaps in the kernel), its
    given form and sampled_eviction, each bit-equal to its plain version
    at E = 1, 2 and 5 experts: lanes whose weights sum below 1e-30 have a
    cdf below every draw, so their choice is E and takes no victim."""
    rng = np.random.default_rng(1000 * K + B + E)
    n, W, lanes = 4000, max(20, 2 * K), 64          # n: not a power of two
    experts = EXPERTS[-E:] if E < 5 else EXPERTS
    size = _t(rng.choice([0, 1, 2, 3, 8, 255], n), cuda)
    last = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    freq = _t(rng.integers(0, 5, n), cuda)               # priority ties
    ins = _t(rng.integers(0, 999, n), cuda)
    w = torch.from_numpy(rng.random((lanes, E)).astype(np.float32) + 1e-4)
    w[::7] = 1e-32
    cdf = t_cache._expert_cdf(w).to(cuda)
    keys = _t(rng.integers(0, 2**32, (lanes, 2), dtype=np.uint64), cuda)
    ts = _t(np.repeat(2**32 - 16 + np.arange(-(-B // lanes)),
                      lanes)[:B] % 2**32, cuda)          # wraps past 2^32
    must = torch.rand(B, device=cuda) < 0.8
    for quota in (_t(rng.integers(0, 4 * K, B), cuda), torch.tensor(
            K, device=cuda)):
        args = (size, ins, last, freq, keys, cdf, must, quota, ts)
        kw = dict(window=W, k=K, experts=experts)
        g = ops.ranked_eviction_draw_op(*args, **kw)
        want = ref.ranked_eviction_draw_ref(*args, **kw)
        for x, y in zip(g, want):
            assert torch.equal(x, y)
        assert B < 63 or (bool((g[2] == E).any())
                          and int((g[0] >= 0).sum()) > 0)
        offs, ech = ref.eviction_draw_ref(keys, cdf, ts, n)
        rargs = (size, ins, last, freq, offs, ech, must, quota, ts)
        g = ops.ranked_eviction_op(*rargs, **kw)
        want = ref.ranked_eviction_ref(*rargs, **kw)
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    pad = lambda x: torch.cat([x.float(), x.new_zeros(W).float()])
    offs = np.append(rng.integers(0, n, B - 1), n)        # last: the tail
    sargs = (pad(size), pad(ins), pad(last), pad(freq), _t(offs, cuda),
             _t(rng.integers(0, E + 1, B), cuda))         # E: no expert
    for clock in (1000.0, torch.tensor(1003.0, device=cuda)):
        g = ops.sampled_eviction_op(*sargs, clock, **kw)
        want = ref.sampled_eviction_ref(*sargs, clock, **kw)
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 2048])
@pytest.mark.parametrize("K", [5, 33, 64])
def test_tenant_draw_form_matches_plain_version_on_the_card(cuda, K, B):
    """The draw form's tenant case (the multi-tenant step's): a tenant
    column over 4 tenants, a filter of -1 and tenant ids, each op's
    tenant picking its (lane, tenant) cdf row of [64, 4, E]; bit-equal to
    the plain version, filtered ops claim only their tenant's slots, and
    with one tenant it equals the untenanted form."""
    rng = np.random.default_rng(7000 + 100 * K + B)
    n, W, lanes, Tn = 4000, max(20, 2 * K), 64, 4
    experts = ("lru", "lfu", "hyperbolic")
    size = _t(rng.choice([0, 1, 2, 3, 8, 255], n), cuda)
    last = _t(rng.integers(0, 2**32, n, dtype=np.uint64), cuda)
    freq = _t(rng.integers(0, 5, n), cuda)
    ins = _t(rng.integers(0, 999, n), cuda)
    tenant = _t(rng.integers(0, Tn, n), cuda)
    w = torch.from_numpy(rng.random((lanes, Tn, 3)).astype(np.float32)
                         + 1e-4)
    w[::7, 1] = 1e-32
    cdf = t_cache._expert_cdf(w).to(cuda)
    keys = _t(rng.integers(0, 2**32, (lanes, 2), dtype=np.uint64), cuda)
    ts = _t(1000 + np.arange(B) // lanes, cuda)
    op_t = rng.integers(0, Tn, B)
    op_tenant = _t(op_t, cuda)
    tfilt = _t(np.where(rng.random(B) < 0.5, -1, op_t), cuda)
    must = torch.rand(B, device=cuda) < 0.8
    quota = _t(rng.integers(0, 4 * K, B), cuda)
    args = (size, ins, last, freq, keys, cdf, must, quota, ts)
    kw = dict(window=W, k=K, experts=experts, tenant=tenant, tfilt=tfilt,
              op_tenant=op_tenant)
    g = ops.ranked_eviction_draw_op(*args, **kw)
    want = ref.ranked_eviction_draw_ref(*args, **kw)
    for x, y in zip(g, want):
        assert torch.equal(x, y)
    v, tf = g[0].cpu().numpy(), tfilt.cpu().numpy()
    ten = tenant.cpu().numpy()
    for b in np.nonzero(tf >= 0)[0]:
        assert (ten[v[b][v[b] >= 0]] == tf[b]).all()
    assert B < 63 or int((g[0] >= 0).sum()) > 0
    base = dict(window=W, k=K, experts=experts)
    one = ops.ranked_eviction_draw_op(*args[:5], cdf[:, 0].contiguous(),
                                      *args[6:], **base)
    as_t = ops.ranked_eviction_draw_op(*args[:5], cdf[:, :1].contiguous(),
                                       *args[6:], **base,
                                       op_tenant=torch.zeros_like(op_tenant))
    for x, y in zip(one, as_t):
        assert torch.equal(x, y)


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
        r2 = execute(r.cache, keys[half:], plan=None, exec_cfg=_keep(cfg),
                     is_write=wr[half:])
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
    r = execute(c, keys, plan=None, exec_cfg=_keep(cfg))
    after = t_types.state_to_numpy(c.state)
    for f in before:
        assert np.array_equal(before[f], after[f]), f
    assert int(r.stats.gets) == int((keys != 0).sum())
    again = execute(c, keys, plan=None, exec_cfg=_keep(cfg))
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
    r1 = execute(c, keys, plan=None, exec_cfg=_keep(cfg), is_write=wr)
    first = ops.launches()
    ops.reset_launches()
    r2 = execute(c, keys[:short], plan=None, exec_cfg=_keep(cfg),
                 is_write=wr[:short])
    assert first == {k: (keys.shape[0] + 1) * CACHE_KERNELS.get(k, 0)
                     for k in first}
    assert ops.launches() == {k: short * CACHE_KERNELS.get(k, 0)
                              for k in first}
    assert [w["compiled"] for w in r1.windows + r2.windows] == [True, False]
    assert np.array_equal(r2.hits, r1.hits[:short])


@pytest.mark.cuda
def test_a_shape_is_captured_once_and_its_call_marks_the_copies(cuda):
    """``graph_captures`` counts one capture on a shape's first call and
    none on the next; under the profiler a call of that shape marks the
    carry's copy into the graph, each replay and the copy out, inside
    its segment."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ExecConfig, spans
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, fc_threshold=11)
    xc = ExecConfig(batch=4, plan="lane")
    keys, wr = gen.interleave(*_ycsb("A", 320, 300, 4))
    n0 = spans.counters()["graph_captures"]
    r = execute(make(cfg, C, 0, device=cuda), keys, exec_cfg=xc, is_write=wr)
    n1 = spans.counters()["graph_captures"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = execute(r.cache, keys, exec_cfg=xc, is_write=wr)
    assert (n1 - n0, spans.counters()["graph_captures"] - n1) == (1, 0)
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.name().startswith("ditto.")
             and str(e.device_type()).endswith("CPU")]
    (w,) = r.windows
    assert names == ["ditto.execute", "ditto.plan", "ditto.upload",
                     "ditto.segment", "ditto.scan.copy_in",
                     *["ditto.scan.step"] * w["n_steps"],
                     "ditto.scan.copy_out", "ditto.merge_stats",
                     "ditto.readback"]


LANE4 = ExecConfig(batch=4, plan="lane")


def _chain(cache, xc, parts) -> list:
    """``execute()`` each (keys, is_write) of ``parts`` in turn, each on
    the handle the last call returned: the results."""
    out = []
    for keys, wr in parts:
        out.append(execute(cache, keys, exec_cfg=xc, is_write=wr))
        cache = out[-1].cache
    return out


def _bit_equal(got, want):
    """Two chains of results: every call's hits, ops and weights and the
    last state, clients and counters, bit for bit."""
    for a, b in zip(got, want, strict=True):
        for x, y in ((a.hits, b.hits), (a.ops, b.ops),
                     (a.weights, b.weights)):
            assert x.tobytes() == y.tobytes()
    a, b = got[-1], want[-1]
    for part in ("state", "clients", "stats"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            assert _same_bits(x, y), (part, f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one", "two", "remade", "remade_elsewhere",
                                  "restored"])
def test_donated_runs_are_bit_equal_to_copying_runs(cuda, case):
    """Chains of donated calls (``ExecConfig.donate``, the card's
    default) against copying ones: one cache; two caches called in turn;
    a new ``make()`` after a donated cache is freed, made after the free
    (the allocator may hand it the old addresses) or before it (new
    addresses); and the old buffers refilled with a fresh state (the same
    addresses: the captured graph replays with no new capture).  Every
    result is bit-equal, and a freed table's graph is dropped."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=4,
                      experts=("lru", "lfu", "hyperbolic"), fc_threshold=13)
    keys, wr = gen.interleave(*_ycsb("A", 2400, 400, 9))
    parts = [(keys[i], wr[i]) for i in np.array_split(
        np.arange(keys.shape[0]), 3)]
    copy, give = (dataclasses.replace(LANE4, donate=d) for d in (False, True))
    want = [_chain(make(cfg, C, s, device=cuda), copy, parts) for s in (0, 1)]
    n0 = spans.counters()
    if case == "one":
        _bit_equal(_chain(make(cfg, C, 0, device=cuda), give, parts), want[0])
    elif case == "two":
        runs = [[], []]
        handles = [make(cfg, C, s, device=cuda) for s in (0, 1)]
        for p in parts:
            for i in (0, 1):
                runs[i] += _chain(handles[i], give, [p])
                handles[i] = runs[i][-1].cache
        assert handles[0].state.values.data_ptr() \
            != handles[1].state.values.data_ptr()
        _bit_equal(runs[0], want[0])
        _bit_equal(runs[1], want[1])
    else:
        first = _chain(make(cfg, C, 0, device=cuda), give, parts)
        _bit_equal(first, want[0])
        graphs = len(t_cache._GRAPHS)
        if case == "restored":
            fresh = make(cfg, C, 1, device=cuda)
            old = first[-1].cache
            for dst, src in zip(old.state, fresh.state):
                dst.copy_(src)
            start = old._replace(clients=fresh.clients, stats=fresh.stats)
            del fresh
        elif case == "remade":
            del first
            start = make(cfg, C, 1, device=cuda)
        else:
            start = make(cfg, C, 1, device=cuda)
            del first
        captures = spans.counters()["graph_captures"]
        _bit_equal(_chain(start, give, parts), want[1])
        assert len(t_cache._GRAPHS) == graphs
        if case == "restored":
            assert spans.counters()["graph_captures"] == captures
    assert spans.counters()["donated_scans"] - n0["donated_scans"] == \
        (3 if case == "one" else 6)


@pytest.mark.cuda
def test_a_donated_handle_is_captured_once_and_counted(cuda):
    """``donated_scans`` counts every segment a donated call runs; the
    second call on the returned handle replays the first call's graph
    (no capture), and its table is the handle's own."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, fc_threshold=15)
    keys, wr = gen.interleave(*_ycsb("A", 960, 300, 10))
    xc = dataclasses.replace(LANE4, plan="adaptive")
    c = make(cfg, C, 0, device=cuda)
    n0 = spans.counters()
    r1 = execute(c, keys, exec_cfg=xc, is_write=wr)
    n1 = spans.counters()
    r2 = execute(r1.cache, keys, exec_cfg=xc, is_write=wr)
    n2 = spans.counters()
    assert n1["donated_scans"] - n0["donated_scans"] == len(r1.windows)
    assert n2["donated_scans"] - n1["donated_scans"] == len(r2.windows)
    assert n1["graph_captures"] > n0["graph_captures"]
    assert n2["graph_captures"] == n1["graph_captures"]
    for f in t_cache.TABLE:
        assert getattr(r2.state, f) is getattr(c.state, f), f


@pytest.mark.cuda
def test_a_donated_capture_leaves_the_table_as_it_was(cuda):
    """Capturing a donated step warms it up on padded lanes over the
    caller's own table: no request reaches it, so after the capture (and
    before any replay) the table and the caller's other leaves are bit
    for bit what they were."""
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, fc_threshold=17,
                      sync_period=4, experts=("lru", "lfu", "hyperbolic"))
    keys, wr = gen.interleave(*_ycsb("A", 1280, 300, 11))
    r = execute(make(cfg, C, 0, device=cuda), keys, exec_cfg=LANE4,
                is_write=wr)
    assert int(r.stats.evictions) > 0
    gp = plan.pack_rows(keys, cfg.n_buckets, 4, is_write=wr)
    xs = t_cache._trace_inputs(_t(gp.keys, cuda),
                               torch.from_numpy(gp.is_write).to(cuda),
                               _t(gp.sizes, cuda), None)
    carry = t_cache._trace_carry(cfg, r.state, r.clients, cuda)
    before = [t.clone() for t in t_cache._leaves(carry)]
    n0 = spans.counters()["graph_captures"]
    t_cache._captured_step(t_cache._group_step(cfg, False),
                           ("test_donated_capture", cfg), carry, xs,
                           donate=True)
    torch.cuda.synchronize(cuda)
    assert spans.counters()["graph_captures"] == n0 + 1
    for i, (a, b) in enumerate(zip(before, t_cache._leaves(carry))):
        assert _same_bits(a, b), i


@pytest.mark.cuda
def test_a_donated_call_holds_no_second_table(cuda):
    """On a table of 524 MB (262,144 slots of 250 words), a donated
    call's peak of allocated memory, its graph's capture included, stays
    within a fifth of the state's bytes above what was allocated before
    it; a copying call's peak holds at least a second state."""
    cfg = CacheConfig(n_buckets=1 << 15, assoc=8, capacity=1 << 17,
                      value_words=250, fc_threshold=19)
    keys, wr = gen.interleave(*_ycsb("A", 4096, 1 << 18, 12))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      make(cfg, C, 0, device=cuda).state)
    peaks = {}
    for donate in (True, False, True):
        c = make(cfg, C, 0, device=cuda)
        xc = dataclasses.replace(LANE4, donate=donate)
        for _ in range(2):
            torch.cuda.synchronize(cuda)
            base = torch.cuda.memory_allocated(cuda)
            torch.cuda.reset_peak_memory_stats(cuda)
            c = execute(c, keys, exec_cfg=xc, is_write=wr).cache
            peaks.setdefault(donate, []).append(
                torch.cuda.max_memory_allocated(cuda) - base)
        del c
    assert max(peaks[True]) < 0.2 * state_bytes, (peaks, state_bytes)
    assert min(peaks[False]) >= state_bytes, (peaks, state_bytes)


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
                        exec_cfg=_keep(cfg), is_write=wr)
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


TENANT_SPECS = (dict(kind="zipf", n_keys=1_000, theta=0.9, lanes=2),
                dict(kind="scan", hot_keys=800, scan_len=300, lanes=2),
                dict(kind="flash", hot_keys=2_000, max_blocks=8, lanes=4))


def _on_card_and_cpu(cuda, cfg, keys, **kw):
    """A grouped segment then a sequential one of ``keys`` on the CPU and
    on the card (graph-replayed), under both backends on the card: the
    four runs' results and the card's launch counts."""
    half = keys.shape[0] // 2
    split = lambda x: (None, None) if x is None else (x[:half], x[half:])
    wr, sz, tn = (split(kw.get(k)) for k in ("is_write", "sizes", "tenants"))
    gp = plan.pack_rows(keys[:half], cfg.n_buckets, 8, is_write=wr[0],
                        sizes=sz[0], tenants=tn[0])
    runs = {}
    for dev, backend in (("cpu", "fused"), (cuda, "fused"),
                         (cuda, "reference")):
        c = dataclasses.replace(cfg, backend=backend)
        ops.reset_launches()
        r = execute(make(c, C, 0, device=dev), keys[:half], plan=gp,
                    is_write=wr[0], sizes=sz[0], tenants=tn[0])
        r2 = execute(r.cache, keys[half:], plan=None, exec_cfg=_keep(c),
                     is_write=wr[1], sizes=sz[1], tenants=tn[1])
        runs[(str(dev), backend)] = (r, r2, ops.launches())
    return runs, gp


@pytest.mark.cuda
def test_multi_tenant_trace_on_the_card_matches_the_cpu(cuda):
    """Three tenants of tenant_mix (a flash crowd of objects up to 8
    blocks) graph-replayed on the card: equal to the CPU run, fused equal
    to reference, every kernel launched once a step, no tenant above its
    budget and ``tenant_bytes`` equal to the table's live sizes."""
    keys, ten, sizes = gen.tenant_mix(C * 300, C, TENANT_SPECS, seed=5)
    cfg = CacheConfig(n_buckets=96, assoc=8, capacity=384, n_tenants=3,
                      sample_window=64, sync_period=10)
    runs, gp = _on_card_and_cpu(cuda, cfg, keys, sizes=sizes, tenants=ten)
    cpu, card, refr = (runs[k] for k in (("cpu", "fused"),
                                         (str(cuda), "fused"),
                                         (str(cuda), "reference")))
    for a, b in ((cpu, card), (card, refr)):
        _same(a[0], b[0])
        _same(a[1], b[1])
    steps = 2 + gp.n_groups + (keys.shape[0] - keys.shape[0] // 2)
    assert card[2] == {k: steps * CACHE_KERNELS.get(k, 0) for k in card[2]}
    st = card[1].state
    live = (st.size != 0) & (st.size != 255)
    occ = [int(st.size[live & (st.tenant == t)].sum()) for t in range(3)]
    assert st.tenant_bytes.tolist() == occ
    assert bool((st.tenant_bytes <= st.tenant_budget).all())
    assert int(card[1].stats.evictions) > 0
    assert card[1].weights.shape[1:] == (3, 2)


@pytest.mark.cuda
def test_l0_trace_on_the_card_matches_the_cpu(cuda):
    """The L0 tier graph-replayed on the card (the seven L0 client arrays
    ride in the captured step's carry, ``bucket_ver`` is written in
    place): equal to the CPU run, fused equal to reference, L0 hits and
    invalidations both seen."""
    keys, wr = gen.interleave(*_ycsb("B", 4800, 300, 6))
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=4,
                      l0_entries=8)
    runs, gp = _on_card_and_cpu(cuda, cfg, keys, is_write=wr)
    cpu, card, refr = (runs[k] for k in (("cpu", "fused"),
                                         (str(cuda), "fused"),
                                         (str(cuda), "reference")))
    for a, b in ((cpu, card), (card, refr)):
        _same(a[0], b[0])
        _same(a[1], b[1])
    st = card[1].stats
    assert int(st.l0_hits) > 0 and int(st.l0_invalidations) > 0
    assert int(card[1].state.bucket_ver.sum()) > 0


@pytest.mark.cuda
def test_the_tenant_and_l0_step_returns_no_whole_column(cuda):
    """One eager fused step of a multi-tenant L0 config: ``tenant_bytes``
    moves by the written slots' change and the L0 bump writes only the
    touched bucket versions, so no operator returns a whole column but
    the bytes_cached reduction's two."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    cfg = CacheConfig(n_buckets=1024, assoc=4, capacity=2048, n_tenants=3,
                      l0_entries=8)
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
    ten = keys % 3
    t_cache.access_group_(cfg, st, cl, sa, keys, tenant=ten)
    with Watch():
        t_cache.access_group_(cfg, st, cl, sa, keys + 1, tenant=ten,
                              is_write=keys > 30)
    assert [f.split(".")[1] for f in seen] == ["eq", "where"], seen


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


# ---------------------------------------------------------------------------
# The DM layer on the card: the sharded pool's group step, S shard steps in
# one captured graph.
# ---------------------------------------------------------------------------

DM_S, DM_LANES = 4, 8


def _dm_cfg(**kw):
    kw = dict(dict(n_buckets=64, assoc=4, capacity=96, sync_period=8,
                   n_tenants=2, tenant_budget_blocks=(64, 64),
                   l0_entries=4), **kw)
    return CacheConfig(**kw)


def _dm_trace(n_groups, G=4, seed=3):
    rng = np.random.default_rng(seed)
    shape = (n_groups, G, DM_S * DM_LANES)
    keys = gen.zipfian(int(np.prod(shape)), 300, 0.9, seed).reshape(shape)
    return (torch.as_tensor(keys.astype(np.int64)),
            torch.as_tensor(rng.random(shape) < 0.3),
            torch.as_tensor(rng.integers(1, 8, shape)),
            torch.as_tensor((keys % 2).astype(np.int64)))


def _dm_run(dev, cfg, trace, group=None):
    """Two segments with a replica election, a failure, its detection and
    a rewarmed recovery between them (``group``: over its ranks)."""
    from repro_torch.dm import Cluster
    cl = Cluster.make(cfg, DM_S, DM_LANES, 5, device=dev, group=group)
    keys, wr, sz, ten = (x.to(dev) for x in trace)
    cl, h1 = cl.execute(keys[:6], wr[:6], sz[:6], ten[:6])
    loads = np.bincount(gen._mix32(trace[0][:6].numpy()).ravel()
                        % cfg.n_buckets, minlength=cfg.n_buckets)
    cl = cl.elect_replicas(loads, 12).inject_failure(1)
    cl, h2 = cl.execute(keys[6:9], wr[6:9], sz[6:9], ten[6:9])
    cl = cl.mark_failed(1)
    cl, h3 = cl.execute(keys[9:14], wr[9:14], sz[9:14], ten[9:14])
    cl, rep = cl.recover(1, rewarm=True)
    cl, h4 = cl.execute(keys[14:], wr[14:], sz[14:], ten[14:])
    return cl, torch.cat([h1, h2, h3, h4]).cpu(), rep


def _same_dm(a, b):
    x, y = t_types.dm_to_numpy(a.dm), t_types.dm_to_numpy(b.dm)
    for part in x:
        for f in x[part]:
            if x[part][f].dtype.kind == "f":
                np.testing.assert_array_max_ulp(x[part][f], y[part][f],
                                                maxulp=16)
            else:
                assert np.array_equal(x[part][f], y[part][f]), (part, f)


@pytest.mark.cuda
def test_dm_trace_on_the_card_matches_the_cpu(cuda):
    """Two tenants, L0, replicas and a failover on 4 shards x 8 lanes:
    the card's fused and reference runs equal the CPU's; the fused run
    launches each cache kernel once a shard step (S a DM step), plus one
    warm-up DM step when the segment's graph is captured."""
    from repro_torch.core import cache as core_cache
    trace = _dm_trace(20)
    cpu = _dm_run("cpu", _dm_cfg(), trace)
    for backend in ("fused", "reference"):
        ops.reset_launches()
        n_graphs = len(core_cache._GRAPHS)
        card = _dm_run(cuda, _dm_cfg(backend=backend), trace)
        captured = len(core_cache._GRAPHS) - n_graphs
        assert torch.equal(card[1], cpu[1])
        assert tuple(card[2]) == tuple(cpu[2]) and card[2].drained_objects > 0
        _same_dm(card[0], cpu[0])
        want = DM_S * (20 + captured) if backend == "fused" else 0
        assert ops.launches() == {k: want * CACHE_KERNELS.get(k, 0)
                                  for k in ops.launches()}
    st = cpu[0].stats
    assert int(st.evictions) > 0 and int(st.replica_writes) > 0
    assert int(st.gets + st.sets + st.route_drops) == int(
        (trace[0] != 0).sum())


def _dm_ranks_equal(one, got) -> None:
    """A rank's run bit-equal to its block of the one-card run: every
    leaf, the hits and the rewarm's report."""
    assert torch.equal(got[1], one[1])
    assert tuple(got[2]) == tuple(one[2]) and got[2].drained_objects > 0
    for a, b in zip(t_cache._leaves(got[0].pool.block(one[0].dm)),
                    t_cache._leaves(got[0].dm)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert [int(x) for x in got[0].stats] == [int(x) for x in one[0].stats]


@pytest.mark.cuda
def test_dm_ranks_one_rank_nccl_equals_one_card(cuda):
    """The pool over a one-rank NCCL group on the card: every leaf, the
    hits and the rewarm bit-equal to the one-card path, S launches of
    each cache kernel a DM step as there."""
    import torch.distributed as dist
    from repro_torch.core import cache as core_cache
    from repro_torch.launch import mesh
    trace = _dm_trace(20)
    one = _dm_run(cuda, _dm_cfg(), trace)
    torch.cuda.set_device(cuda)
    mesh._group("nccl", 1, dist.HashStore)
    try:
        ops.reset_launches()
        n_graphs = len(core_cache._GRAPHS)
        got = _dm_run(cuda, _dm_cfg(), trace, group=dist.group.WORLD)
        captured = len(core_cache._GRAPHS) - n_graphs
        _dm_ranks_equal(one, got)            # its global stats: the group
    finally:
        mesh.teardown()
    want = DM_S * (20 + captured)
    assert ops.launches() == {k: want * CACHE_KERNELS.get(k, 0)
                              for k in ops.launches()}


def _dm_ranks_worker(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        trace = _dm_trace(20)
        one = _dm_run(dev, _dm_cfg(), trace)
        _dm_ranks_equal(one, _dm_run(dev, _dm_cfg(), trace,
                                     group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dm_ranks_two_gloo_processes_on_one_card(cuda, tmp_path):
    """Two processes on one card over gloo, two shards each: each rank's
    block bit-equal to the one-card run it makes beside it."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import runtime
    runtime.lib()                         # one build before the ranks
    mp.start_processes(_dm_ranks_worker, args=(2, str(tmp_path / "store")),
                       nprocs=2, join=True, start_method="spawn")


def _dm_ranks_nccl_worker(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        trace = _dm_trace(20)
        one = _dm_run(dev, _dm_cfg(), trace)
        _dm_ranks_equal(one, _dm_run(dev, _dm_cfg(), trace,
                                     group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dm_ranks_one_nccl_rank_a_card(cuda, tmp_path):
    """One NCCL rank a card, on 2 or 4 cards: each rank's block
    bit-equal to the one-card run it makes on its own card."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import runtime
    world = max((r for r in (2, 4) if r <= torch.cuda.device_count()),
                default=0)
    if not world:
        pytest.skip("needs two or more cards: one NCCL rank a card")
    runtime.lib()
    mp.start_processes(_dm_ranks_nccl_worker,
                       args=(world, str(tmp_path / "store")), nprocs=world,
                       join=True, start_method="spawn")


@pytest.mark.cuda
def test_a_membership_change_replays_the_same_graph(cuda):
    """Replicas, a failure and its detection change the routed inputs
    only: the DM step is captured once, and a later segment launches each
    kernel exactly S times a step (no warm-up)."""
    from repro_torch.core import cache as core_cache
    from repro_torch.dm import Cluster
    cfg = _dm_cfg(l0_entries=0, n_tenants=1, tenant_budget_blocks=(),
                  fc_threshold=7)
    keys, wr, _, _ = (x.to(cuda) for x in _dm_trace(12))
    cl = Cluster.make(cfg, DM_S, DM_LANES, 5, device=cuda)
    cl, _ = cl.execute(keys[:3], wr[:3])
    n_graphs = len(core_cache._GRAPHS)
    for change in (lambda c: c.elect_replicas(np.arange(cfg.n_buckets), 16),
                   lambda c: c.inject_failure(2), lambda c: c.mark_failed(2),
                   lambda c: c.recover(2)[0]):
        cl = change(cl)
        ops.reset_launches()
        cl, _ = cl.execute(keys[3:6], wr[3:6])
        assert ops.launches() == {k: 3 * DM_S * CACHE_KERNELS.get(k, 0)
                                  for k in ops.launches()}
    assert len(core_cache._GRAPHS) == n_graphs


@pytest.mark.cuda
def test_a_sanitized_dm_segment_raises_on_a_corrupted_carry(cuda):
    """The armed DM step folds each shard's checks into the carried word,
    read once after the segment: a clean run (a pool the trace's 300 keys
    fit in) equals the unarmed one, and a duplicated live key in one
    bucket of shard 2 raises SAN003."""
    import dataclasses
    from repro_torch.analysis.sanitize import SanitizerError
    from repro_torch.dm import Cluster
    cfg = _dm_cfg(n_buckets=256, capacity=512, l0_entries=0, n_tenants=1,
                  tenant_budget_blocks=())
    keys, wr, _, _ = (x.to(cuda) for x in _dm_trace(8))
    scfg = dataclasses.replace(cfg, sanitize=True)
    a, ha = Cluster.make(cfg, DM_S, DM_LANES, 5, device=cuda).execute(
        keys, wr)
    b, hb = Cluster.make(scfg, DM_S, DM_LANES, 5, device=cuda).execute(
        keys, wr)
    assert torch.equal(ha, hb)
    _same_dm(a, b)
    ls, A = b.local.n_slots, cfg.assoc
    size = b.dm.state.size[2 * ls:3 * ls]
    live = ((size != 0) & (size != 255)).reshape(-1, A)
    bkt = int(torch.nonzero(live.sum(dim=1) >= 2)[0, 0])
    i, j = (2 * ls + bkt * A + torch.nonzero(live[bkt])[:2, 0]).tolist()
    key = b.dm.state.key.clone()
    key[j] = key[i]
    bad = b._replace(dm=b.dm._replace(state=b.dm.state._replace(key=key)))
    with pytest.raises(SanitizerError, match="SAN003"):
        bad.execute(keys[:2], wr[:2])


def _host_seq(x):
    """Rows in order, one f32 add at a time (XLA's CPU order)."""
    acc = x[0].copy()
    for row in x[1:]:
        acc = (acc + row).astype(np.float32)
    return acc


def _host_xla0(x):
    return _host_seq(np.stack([_host_seq(x[a:b])
                               for a, b in t_cache._xla_chunks(x.shape[0])]))


def _host_cum_last(x):
    out = x.copy()
    for i in range(1, x.shape[-1]):
        out[..., i] = (out[..., i - 1] + x[..., i]).astype(np.float32)
    return out


def _host_sum_last(x):
    return _host_seq(np.moveaxis(x, -1, 0))


def _ordered_sum_cases():
    from repro_torch.elastic.resize import _tenant_mean
    f32 = np.float32

    def cdf(w):
        s = np.maximum(_host_sum_last(w), f32(1e-30))
        return _host_cum_last((w / s[..., None]).astype(f32))

    def norm(w):
        w = np.maximum(w, f32(1e-4))
        return (w / _host_sum_last(w)[..., None]).astype(f32)

    return {
        "seqsum": (t_cache._seqsum, _host_seq),
        "xla_sum0": (t_cache._xla_sum0, _host_xla0),
        "seqsum_last": (t_cache._seqsum_last, _host_sum_last),
        "seqcumsum_last": (t_cache._seqcumsum_last, _host_cum_last),
        "expert_cdf": (t_cache._expert_cdf, cdf),
        "apply_penalties": (lambda w: t_cache.apply_penalties(
            w, torch.zeros_like(w), 0.1), norm),
        "tenant_mean": (_tenant_mean, lambda x: (_host_xla0(x) * (
            f32(1) / f32(x.shape[0]))).astype(f32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["seqsum", "xla_sum0", "seqsum_last",
                                "seqcumsum_last", "expert_cdf",
                                "apply_penalties", "tenant_mean"])
def test_ordered_sums_match_a_host_loop_on_the_card(cuda, op):
    """The float sums that follow XLA's CPU order (F1) take one scan on
    the card: at 1 to 128 rows, E = 1 to 8, with no, one and three
    columns (a lone column is widened), bit-equal to a host f32 loop."""
    fn, host = _ordered_sum_cases()[op]
    rng = np.random.default_rng(11)
    for R in (1, 4, 31, 32, 33, 40, 64, 65, 128):
        for E in range(1, 9):
            for cols in ((), (1,), (3,)):
                shape = (R,) + cols + (E,)
                x = (rng.random(shape, dtype=np.float32)
                     * rng.choice(np.float32([1e-3, 1.0, 1e3]), shape))
                got = fn(torch.from_numpy(x).to(cuda)).cpu().numpy()
                want = host(x)
                assert got.shape == want.shape
                assert np.array_equal(got.view(np.int32),
                                      want.view(np.int32)), (op, shape)


@pytest.mark.cuda
def test_drain_and_lane_resize_on_the_card_match_the_cpu(cuda):
    """The shrink drain (one batched pass over the shards a step), the
    lane grow and the flush back, from the same state on the card and on
    the CPU: every leaf and report equal, and the drained cluster serves
    on."""
    from repro_torch.dm import Cluster
    cfg = _dm_cfg(capacity=256, n_buckets=128, assoc=4, l0_entries=0)
    keys, wr, sz, ten = _dm_trace(6)
    cpu, _ = Cluster.make(cfg, DM_S, DM_LANES, 5, device="cpu").execute(
        keys, wr, sz, ten)
    card = cpu._replace(device=cuda, dm=t_types.dm_from_numpy(
        t_types.dm_to_numpy(cpu.dm), device=cuda))
    for change in (lambda c: c.with_lanes(12), lambda c: c.with_lanes(3),
                   lambda c: c.drain_to(32, batch_per_shard=4)):
        (a, ra), (b, rb) = change(cpu), change(card)
        assert ra == rb
        x, y = t_types.dm_to_numpy(a.dm), t_types.dm_to_numpy(b.dm)
        for part in x:
            for f in x[part]:
                assert np.array_equal(x[part][f], y[part][f]), (part, f)
    assert rb.drain_steps >= 2
    assert bool((b.dm.state.bytes_cached <= 8).all())
    b, _ = b.execute(keys[:2, :, :DM_S * DM_LANES].to(cuda))


@pytest.mark.cuda
def test_scenario_on_the_card_matches_the_cpu(cuda):
    """``run_scenario`` with a health monitor, per-window replica
    election, a failure and its recovery, a lane change and a shrink, on
    the card and on the CPU: the same windows and events."""
    from repro_torch.elastic import HealthMonitor, run_scenario
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96)
    trace = gen.failover_trace(48, 4, 4, 64, hot_shard=1, hot_fraction=0.7,
                               n_hot=12, n_keys=300, seed=7).ravel()
    timeline = [(8, ("set_lanes", 6)), (16, ("fail_shard", 1)),
                (32, ("recover_shard", 1)), (40, ("set_capacity", 48))]
    runs = [run_scenario(cfg, trace, timeline, n_shards=4, lanes_per_shard=4,
                         horizon=48, window=4, health=HealthMonitor(4),
                         replicate_hot=8, seed=7, drain_batch=8, device=d)
            for d in ("cpu", cuda)]
    assert runs[0].windows == runs[1].windows
    assert runs[0].events == runs[1].events
    assert [e["t"] for e in runs[1].events if e["event"] == "mark_failed"] \
        == [24]


# ---------------------------------------------------------------------------
# The training path (no hand-written kernel: the plain attention under
# autograd, AdamW, checkpoints, gradient compression).
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_flash_op_refuses_inputs_that_require_grad_on_the_card(cuda):
    q, k, v = (torch.randn(1, 64, 2, 64, device=cuda) for _ in range(3))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="full_attention"):
        ops.flash_attention_op(q, k, v)
    ops.reset_launches()
    with torch.no_grad():
        out = ops.flash_attention_op(q, k, v)
    assert out.grad_fn is None and ops.launches()["flash_attention"] == 1


def _train_setup(dev):
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train import AdamWConfig, init_opt, make_train_step
    from repro_torch.train.optimizer import tree_map
    cfg = smoke_config(get_arch("smollm-135m"))
    params = tree_map(lambda t: t.to(dev), init_params(
        cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu"))
    batch = synthetic_batches(cfg, 8, 32, device="cpu")(0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, ocfg, n_microbatches=2, remat="full")
    return ocfg, step(params, init_opt(params),
                      {k: v.to(dev) for k, v in batch.items()})


@pytest.mark.cuda
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 train step (two microbatches, full remat) on the card and
    the CPU, from the same params and batch: loss, m and v within 1e-4
    (abs and rel); the master within it where Adam's normalised step is
    well conditioned (sqrt(v_hat) >= 100 eps), within the step's reach
    (2 lr) elsewhere.  No hand-written kernel launches."""
    from repro_torch.train.optimizer import lr_at, tree_leaves
    ops.reset_launches()
    ocfg, (pc, oc, lc) = _train_setup(cuda)
    assert not any(ops.launches().values())
    _, (pp, op, lp) = _train_setup("cpu")
    np.testing.assert_allclose(float(lc), float(lp), rtol=1e-4, atol=1e-4)
    assert pc["embed"].device.type == cuda.type and int(oc.step) == 1
    bc2 = 1 - np.float32(ocfg.b2)
    reach = 2 * float(lr_at(ocfg, torch.tensor(1.0)))
    for part in ("m", "v", "master"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(oc, part)),
                                       tree_leaves(getattr(op, part)))):
            a, b = a.cpu().numpy(), b.numpy()
            ok = np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)
            if part == "master":
                v = tree_leaves(op.v)[i].numpy()
                ill = np.sqrt(v / bc2) < 100 * ocfg.eps
                ok |= ill & (np.abs(a - b) <= reach + 1e-4)
            assert ok.all(), (part, i)


@pytest.mark.cuda
def test_compress_on_the_card_is_bit_equal_to_the_cpu(cuda):
    from repro_torch.train import grad_compress as gc
    rng = np.random.default_rng(0)
    for n in (4096, 5000, 1 << 20):
        g = torch.from_numpy((rng.normal(size=n) * rng.exponential(1, n))
                             .astype(np.float32))
        st_c, st_g = gc.init_compress(n), gc.init_compress(n, cuda)
        for _ in range(2):
            qc, sc, st_c = gc.compress(g, st_c)
            qg, sg, st_g = gc.compress(g.to(cuda), st_g)
            assert torch.equal(qg.cpu(), qc)
            for a, b in ((sg, sc), (st_g.error, st_c.error)):
                assert torch.equal(a.cpu().view(torch.int32),
                                   b.view(torch.int32))
        dg, _ = gc.compressed_allreduce(g.to(cuda), gc.init_compress(n, cuda))
        dc, _ = gc.compressed_allreduce(g, gc.init_compress(n))
        assert torch.equal(dg.cpu().view(torch.int32), dc.view(torch.int32))


@pytest.mark.cuda
def test_checkpoint_from_card_tensors_restores_on_the_cpu(cuda, tmp_path):
    from repro_torch.train import CheckpointManager, init_opt
    from repro_torch.train.optimizer import tree_leaves, tree_map
    cfg = smoke_config(get_arch("smollm-135m"))
    params = init_params(cfg, generator=torch.Generator(device=cuda)
                         .manual_seed(3), device=cuda)
    opt = init_opt(params)
    opt = opt._replace(step=opt.step + 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"params": params, "opt": opt})
    mgr.wait()
    like_p = tree_map(lambda t: t.cpu(), params)
    got = mgr.restore(5, {"params": like_p, "opt": init_opt(like_p)})
    assert int(got["opt"].step) == 5
    for a, b in zip(tree_leaves(params) + tree_leaves(opt.master),
                    tree_leaves(got["params"]) + tree_leaves(got["opt"].master)):
        assert b.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_moe_routing_on_the_card_equals_the_cpu(cuda):
    """The stable sort keeps equal gates in index order on the card too:
    the same logits, ties among them, route to the same experts, places
    and slots as on the CPU (which ``tests/test_torch_zoo_blocks.py``
    holds bit-equal to JAX's ``lax.top_k`` routing)."""
    from repro_torch.models import moe
    rng = np.random.default_rng(20)
    for n, e, k, cf in ((4096, 64, 8, 1.25), (4096, 64, 6, 1.25),
                        (128, 64, 8, 0.5), (4, 64, 8, 1.25)):
        ties = torch.from_numpy((rng.integers(0, 6, (n, e)) * 0.25
                                 ).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((n, 256))).to(torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal((256, e)) * 0.05
                             ).to(torch.bfloat16)
        for logits in (ties, (x @ w).float()):
            rc = moe.moe_route(logits, k, cf)
            rg = moe.moe_route(logits.to(cuda), k, cf)
            for name in ("topi", "pos", "keep", "idx_buf"):
                assert torch.equal(getattr(rg, name).cpu(),
                                   getattr(rc, name)), (n, e, k, name)
            torch.testing.assert_close(rg.topv.cpu(), rc.topv, rtol=1e-6,
                                       atol=1e-6)
        assert (torch.sort(ties, -1, descending=True).values[:, k - 1]
                == torch.sort(ties, -1, descending=True).values[:, k]
                ).float().mean() > 0.5


@pytest.mark.cuda
def test_rglru_scan_on_the_card_matches_a_sequential_loop(cuda):
    """The log-depth scan against h_t = a_t h_{t-1} + b_t one step at a
    time, both in f32 on the card, with and without a carried state:
    within 1e-5 (the decay a_t < 1 keeps rounding from growing)."""
    from repro_torch.models import rglru
    rng = np.random.default_rng(21)
    d, t = 256, 1000

    def tn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale
                                ).float().to(cuda)

    p = {"w_a": tn(d, d, scale=d ** -0.5), "b_a": tn(d, scale=0.1),
         "w_i": tn(d, d, scale=d ** -0.5), "b_i": tn(d, scale=0.1),
         "lam": torch.linspace(2.2, 6.9, d, device=cuda)}
    u = tn(2, t, d)
    for h0 in (None, tn(2, d)):
        y, h_last = rglru.rglru_scan(u, p, h0)
        a, g = rglru._gates(u, p)
        b = g * u
        h = torch.zeros(2, d, device=cuda) if h0 is None else h0
        want = []
        for s in range(t):
            h = a[:, s] * h + b[:, s]
            want.append(h)
        want = torch.stack(want, 1)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h_last, want[:, -1], rtol=1e-5, atol=1e-5)


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_shapes(y) for y in x)
    return x


@pytest.mark.cuda
def test_each_kernel_op_fake_gives_the_kernel_shapes(cuda):
    """Every custom op of kernels/library.py: its fake implementation
    (fake CUDA tensors) gives the shapes and dtypes the kernel gives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    g = torch.Generator(device=cuda).manual_seed(0)
    i64 = lambda *s, hi=64: torch.randint(0, hi, s, generator=g, device=cuda)
    f32 = lambda *s: torch.rand(s, generator=g, device=cuda)
    n, B, k = 64, 8, 3
    col = lambda: i64(n, hi=200)
    cases = {
        "bucket_lookup": (ops.bucket_lookup_op, (col(), col(), i64(B)),
                          dict(assoc=4)),
        "access_probe": (ops.access_probe_op,
                         (col(), col(), col(), col(), i64(B),
                          torch.tensor(5, device=cuda)),
                         dict(assoc=4, history_len=8)),
        "access_probe_facts": (ops.access_probe_op,
                               (col(), col(), col(), col(), i64(B),
                                torch.tensor(5, device=cuda)),
                               dict(assoc=4, history_len=8,
                                    meta=(col(), col(), col()), ts=i64(B),
                                    experts=("lru", "lfu"))),
        "hit_metadata_update": (ops.hit_metadata_update_op,
                                (col(), col(), f32(n, 4), i64(B), i64(B),
                                 i64(B), i64(B)), {}),
        "ranked_eviction": (ops.ranked_eviction_op,
                            (col(), col(), col(), col(), i64(B), i64(B, hi=2),
                             torch.ones(B, dtype=torch.bool, device=cuda),
                             torch.ones(B, dtype=torch.int64, device=cuda),
                             i64(B)), dict(window=8, k=k,
                                           experts=("lru", "lfu"))),
        "ranked_eviction_draw": (ops.ranked_eviction_draw_op,
                                 (col(), col(), col(), col(), i64(4, 2),
                                  f32(4, 2), torch.ones(B, dtype=torch.bool,
                                                        device=cuda),
                                  torch.tensor(1, device=cuda), i64(B)),
                                 dict(window=8, k=k, experts=("lru", "lfu"))),
        "flash_attention": (ops.flash_attention_op,
                            tuple(torch.randn(1, 128, 4, 64, device=cuda,
                                              dtype=torch.bfloat16)
                                  for _ in range(3)), {}),
        "sampled_eviction": (ops.sampled_eviction_op,
                             (f32(n + 8), f32(n + 8), f32(n + 8), f32(n + 8),
                              i64(B), i64(B, hi=2), 3.0), dict(window=8, k=k)),
        "metadata_update": (ops.metadata_update_op,
                            (f32(n), f32(n), i64(B), f32(B), 3.0), {}),
    }
    for name, (fn, args, kw) in cases.items():
        want = _shapes(fn(*args, **kw))
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = lambda t: (mode.from_tensor(t)
                              if isinstance(t, torch.Tensor) else t)
            got = _shapes(fn(*tree_map(fake, args),
                             **tree_map(fake, kw)))
        assert got == want, name
    # The in-place ops keep their columns' shapes and write nothing fake.
    cols = (col(), f32(n))
    with FakeTensorMode() as mode:
        fc = tuple(mode.from_tensor(c) for c in cols)
        ops.drop_scatter_op_(mode.from_tensor(i64(B)), fc,
                             (1, mode.from_tensor(f32(B))))
        ops.metadata_update_op_(mode.from_tensor(f32(n)),
                                mode.from_tensor(f32(n)),
                                mode.from_tensor(i64(B)),
                                mode.from_tensor(f32(B)), 1.0)
        assert _shapes(fc) == _shapes(cols)


@pytest.mark.cuda
def test_one_rank_mesh_train_step_equals_the_plain_step(cuda):
    """A smoke train step with DTensor params and the ZeRO-1 specs live on
    the one-rank card mesh: every output leaf bit-equal to the plain
    step's."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_param_specs
    from repro_torch.train import (AdamWConfig, init_opt, make_train_step,
                                   zero_specs)
    from repro_torch.train.optimizer import tree_leaves
    cfg = smoke_config(get_arch("smollm-135m"))
    params = init_params(cfg, generator=torch.Generator(device=cuda)
                         .manual_seed(0), device=cuda)
    batch = synthetic_batches(cfg, 4, 64, seed=0, device=cuda)(0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    kw = dict(n_microbatches=2, remat="full")
    want = make_train_step(cfg, ocfg, **kw)(params, init_opt(params), batch)
    mesh = M.make_card_mesh(0)
    try:
        specs = build_param_specs(cfg, model_shards=1)
        zspecs = zero_specs(specs, params, mesh)
        step = make_train_step(cfg, ocfg, param_specs=specs, zspecs=zspecs,
                               **kw)
        with sh.use_mesh(mesh):
            dp = sh.distribute_tree(params, specs, mesh)
            db = {k: sh.distribute(v, sh.P("dp", None), mesh)
                  for k, v in batch.items()}
            got = step(dp, init_opt(dp, zspecs), db)
    finally:
        M.teardown()
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    for a, b in zip(tree_leaves(got[0]) + [x for t in got[1][1:]
                                           for x in tree_leaves(t)]
                    + [got[2]],
                    tree_leaves(want[0]) + [x for t in want[1][1:]
                                            for x in tree_leaves(t)]
                    + [want[2]]):
        assert torch.equal(full(a), b)


@pytest.mark.cuda
def test_flash_roofline_bound_is_under_the_kernel_time(cuda):
    """The counter's bound of one flash call at yi-9b's shape, T = 4096
    (its FLOPs over 989 TFLOP/s), is no more than the kernel's measured
    time."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_cost import count
    q = torch.randn(1, 4096, 32, 128, device=cuda, dtype=torch.bfloat16)
    kv = attention.repeat_kv(torch.randn(1, 4096, 4, 128, device=cuda,
                                         dtype=torch.bfloat16), 8)
    _, c = count(ops.flash_attention_op, q, kv, kv)
    bound_ms = c.flops / rl.PEAK_FLOPS * 1e3
    assert bound_ms == pytest.approx(0.139, rel=0.005)
    ops.flash_attention_op(q, kv, kv)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(10):
        ops.flash_attention_op(q, kv, kv)
    b.record()
    torch.cuda.synchronize()
    assert a.elapsed_time(b) / 10 >= bound_ms
