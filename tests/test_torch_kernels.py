"""The port's cache kernels against the JAX package's Pallas kernels, on
the CPU: the three of the main path, and the three that only the
``kernels.ops`` entry point reaches (``sampled_eviction``,
``bucket_lookup``, ``metadata_update``).

Each plain version in ``repro_torch/kernels/ref.py`` (what the op
wrappers run for CPU tensors) is held against the Pallas kernel it
stands for, run in interpret mode as ``tests/test_kernels.py`` runs it:
duplicates, -1 no-ops, odd batch sizes, history ages that wrap mod
2^32, per-op quotas above one block, tenant filters and W = 128; the
entry point's three on ``tests/test_kernels.py``'s own shapes, experts
and seeds; samples of K = 33 and 64, wider than a warp.  The probe's
facts form is held against the JAX package's own step code
(``repro/core/cache.py:396-413``), and the apply's multi-group
``drop_scatter`` against XLA's drop-mode scatters group by group.  The
ranked eviction's draw form (the fused step's) is held against the JAX
step's own threefry draw, expert choice, Pallas ``ranked_eviction`` and
victim bitmap, with and without tenants (each op's choice from its
(lane, tenant) weights, its sample scoped by the tenant filter).  Integer outputs are bit-equal; the f32 ``ext`` column is
held to ``assert_array_max_ulp(maxulp=4)`` (XLA and PyTorch round
``exp`` apart); ``metadata_update``'s ``freq`` is bit-equal on integer
deltas and within ``rtol=1e-6`` on non-integer ones (the Pallas kernel
sums a slot's deltas before adding them, the port adds them one by one
in batch order).  Where the JAX op asserts a tiling (B % 8, C % 512),
the port's other shapes are held against ``repro/kernels/ref.py``.

The CUDA kernels themselves build and run only on the card:
``tests/test_torch_cuda.py`` compares them with the plain versions there.
"""

import os
import re
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as j_cache
from repro.core import priority as j_prio
from repro.core import types as j_types
from repro.core.hashing import bucket_of as j_bucket_of
from repro.core.hashing import hash_key as j_hash_key
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, runtime
from repro_torch.kernels.sampled_eviction import KERNEL_EXPERTS

EXPERTS = ("lru", "lfu", "fifo", "size", "hyperbolic")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _table(rng, n_buckets, assoc, hist_ctr, history_len):
    """Live keys in their own buckets, history entries whose age wraps
    (ptr ahead of hist_ctr) or is past history_len, empty slots."""
    n = n_buckets * assoc
    key = rng.integers(1, 2**32, n, dtype=np.uint64).astype(np.uint32)
    kh = np.asarray(j_hash_key(jnp.asarray(key)))
    # Move each key to a slot of its own bucket where one is free.
    tk = np.zeros(n, np.uint32)
    th = np.zeros(n, np.uint32)
    fill = np.zeros(n_buckets, np.int64)
    for k, h in zip(key, kh):
        b = int(h % n_buckets)
        if fill[b] < assoc:
            s = b * assoc + fill[b]
            tk[s], th[s] = k, h
            fill[b] += 1
    placed = tk != 0
    kind = rng.random(n)
    size = np.where(placed, np.where(kind < 0.55, rng.integers(1, 9, n), 255),
                    0).astype(np.uint32)
    age = rng.integers(0, 2 * history_len, n)
    ptr = np.where(size == 255, (hist_ctr - age) % 2**32, 0).astype(np.uint32)
    return tk, size, th, ptr


# ---------------------------------------------------------------------------
# access_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_buckets,assoc,B", [
    (0, 32, 4, 13), (1, 64, 8, 64), (2, 128, 8, 257), (3, 16, 2, 5)])
def test_access_probe_matches_pallas(seed, n_buckets, assoc, B):
    rng = np.random.default_rng(seed)
    hist_ctr, history_len = 7, 40        # ptr > hist_ctr: the age wraps
    tk, size, th, ptr = _table(rng, n_buckets, assoc, hist_ctr, history_len)
    u = rng.random(B)
    keys = np.where(u < 0.4, rng.choice(tk[(size > 0) & (size < 255)], B),
                    np.where(u < 0.7, rng.choice(tk[size == 255], B),
                             rng.integers(1, 2**32, B, dtype=np.uint64)))
    keys = keys.astype(np.uint32)
    keys[: min(3, B)] = keys[0]          # duplicates
    keys[-1] = 0
    want = jops.access_probe_op(
        jnp.asarray(tk), jnp.asarray(size), jnp.asarray(th), jnp.asarray(ptr),
        jnp.asarray(keys), jnp.uint32(hist_ctr), assoc=assoc,
        history_len=history_len)
    got = ops.access_probe_op(_t(tk), _t(size), _t(th), _t(ptr), _t(keys),
                              torch.tensor(hist_ctr), assoc=assoc,
                              history_len=history_len)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert bool(got[0].any())
    assert bool(got[2].any()) or B < 8


def _jax_insert_facts(cfg, tk, size, th, ptr, meta, keys, ts, e_choice,
                      hist_ctr):
    """The insert path's bucket quantities as the JAX package's step
    computes them (``repro/core/cache.py:396-413``, with the bucket
    gathers of its probe, ``:245-256``), on this table."""
    U32, F32 = jnp.uint32, jnp.float32
    state = j_types.init_cache(cfg)._replace(
        key=jnp.asarray(tk), size=jnp.asarray(size), key_hash=jnp.asarray(th),
        ptr=jnp.asarray(ptr), insert_ts=jnp.asarray(meta[0]),
        last_ts=jnp.asarray(meta[1]), freq=jnp.asarray(meta[2]),
        hist_ctr=jnp.uint32(hist_ctr))
    A, names = cfg.assoc, cfg.experts
    kh = j_hash_key(jnp.asarray(keys))
    bucket = j_bucket_of(kh, cfg.n_buckets)
    bslots = bucket[:, None] * A + jnp.arange(A)[None, :]
    b_size = state.size[bslots]
    b_ptr = state.ptr[bslots]
    live = j_cache._is_live(b_size)
    is_hist = b_size == j_types.SIZE_HISTORY
    h_age = j_cache._hist_age(state.hist_ctr, b_ptr)
    h_valid = is_hist & (h_age < U32(cfg.history_len))
    ts_req = jnp.asarray(ts)
    e_choice = jnp.asarray(e_choice)

    free = (b_size == j_types.SIZE_EMPTY) | (is_hist & ~h_valid)
    has_free = jnp.any(free, axis=1)
    free_slot = jnp.take_along_axis(
        bslots, jnp.argmax(free, axis=1)[:, None], axis=1)[:, 0]
    b_md = j_cache._md_view(state, bslots, ts_req[:, None])
    b_prio = j_prio.priorities(b_md, names)
    b_prio_e = jnp.take_along_axis(
        b_prio, e_choice[:, None, None], axis=2)[:, :, 0]
    b_prio_e = jnp.where(live, b_prio_e, jnp.inf)
    fb_obj_slot = jnp.take_along_axis(
        bslots, jnp.argmin(b_prio_e, axis=1)[:, None], axis=1)[:, 0]
    hist_age_in_bucket = jnp.where(h_valid, h_age.astype(F32), -jnp.inf)
    fb_hist_slot = jnp.take_along_axis(
        bslots, jnp.argmax(hist_age_in_bucket, axis=1)[:, None], axis=1)[:, 0]
    has_valid_hist = jnp.any(h_valid, axis=1)
    has_live = jnp.any(live, axis=1)
    return dict(key_hash=kh, bucket=bucket, free_slot=free_slot,
                has_free=has_free, hist_slot=fb_hist_slot,
                has_hist=has_valid_hist, has_live=has_live,
                fb_obj_slot=fb_obj_slot)


@pytest.mark.parametrize("seed,n_buckets,assoc,B,case,experts", [
    (0, 32, 4, 40, "mixed", EXPERTS), (1, 16, 6, 37, "mixed", EXPERTS),
    (2, 32, 8, 64, "mixed", ("lru", "lfu")),
    (3, 8, 16, 29, "mixed", ("hyperbolic", "fifo", "size")),
    (4, 16, 8, 33, "all_history", EXPERTS), (5, 16, 8, 33, "full", EXPERTS),
    (6, 4, 40, 11, "mixed", EXPERTS)])
def test_access_probe_facts_match_the_jax_step(seed, n_buckets, assoc, B,
                                               case, experts):
    """The probe's facts form (the plain version the op runs on the CPU)
    against the JAX package's own step code on the same table: the free
    slot, the oldest valid history entry, the live test and the bucket
    argmin of every expert choice, E (every cdf entry below the draw: the
    gather reads NaN) included; buckets of history entries only, and
    full buckets of live objects; assoc above one warp's 32 lanes."""
    rng = np.random.default_rng(seed)
    hist_ctr, history_len = 7, 40
    tk, size, th, ptr = _table(rng, n_buckets, assoc, hist_ctr, history_len)
    n = n_buckets * assoc
    if case == "all_history":
        size[:] = 255
        ptr = ((hist_ctr - rng.integers(0, 2 * history_len, n))
               % 2**32).astype(np.uint32)
        ptr[:assoc] = ptr[0]                     # equal ages: ties
    elif case == "full":
        size = rng.integers(1, 9, n).astype(np.uint32)
    ins = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ins[: n // 2] = rng.integers(900, 1000, n // 2)   # small ages too
    last = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    freq = rng.integers(0, 5, n).astype(np.uint32)    # priority ties
    u = rng.random(B)
    keys = np.where(u < 0.4, rng.choice(tk[tk != 0], B),
                    rng.integers(1, 2**32, B, dtype=np.uint64))
    keys = keys.astype(np.uint32)
    keys[-1] = 0
    ts = (1000 + rng.integers(0, 8, B)).astype(np.uint32)
    E = len(experts)
    cfg = j_types.CacheConfig(n_buckets=n_buckets, assoc=assoc,
                              capacity=n // 2, hist_len=history_len,
                              experts=experts)
    got = ops.access_probe_op(
        _t(tk), _t(size), _t(th), _t(ptr), _t(keys), torch.tensor(hist_ctr),
        assoc=assoc, history_len=history_len,
        meta=(_t(ins), _t(last), _t(freq)), ts=_t(ts), experts=experts)
    facts = got[4]
    plain = ops.access_probe_op(
        _t(tk), _t(size), _t(th), _t(ptr), _t(keys), torch.tensor(hist_ctr),
        assoc=assoc, history_len=history_len)
    for g, w in zip(got[:4], plain):
        assert torch.equal(g, w)
    assert facts.cand.shape == (B, E + 1)
    for e in range(E + 1):
        want = _jax_insert_facts(cfg, tk, size, th, ptr, (ins, last, freq),
                                 keys, ts, np.full(B, e, np.int32), hist_ctr)
        assert np.array_equal(facts.cand[:, e].numpy(),
                              np.asarray(want.pop("fb_obj_slot")))
    for f, w in want.items():
        g = getattr(facts, f).numpy()
        assert np.array_equal(g, np.asarray(w).astype(g.dtype)), f
    live = (size > 0) & (size < 255)
    if case == "all_history":
        assert not facts.has_live.any() and facts.has_hist.any()
    if case == "full":
        assert facts.has_live.all() and not facts.has_free.any()
    if case == "mixed":
        assert facts.has_free.any() and facts.has_hist.any() and live.any()


# ---------------------------------------------------------------------------
# hit_metadata_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,C,Bh,Be", [(0, 11, 7, 9), (1, 32, 33, 64),
                                          (2, 24, 1, 3), (3, 17, 40, 5)])
def test_hit_metadata_update_matches_pallas(seed, C, Bh, Be):
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 2**32 - 64, C, dtype=np.uint64).astype(np.uint32)
    freq[:3] = [0, 1, 2**32 - 100]
    last = rng.integers(0, 5000, C).astype(np.uint32)
    ext = rng.uniform(0, 60, (C, 4)).astype(np.float32)
    hit = np.where(rng.random(Bh) < 0.75, rng.integers(0, C, Bh), -1)
    hit[: min(4, Bh)] = hit[0]            # duplicate hits on one slot
    hts = (5000 + rng.integers(0, 8, Bh)).astype(np.uint32)
    emit = np.where(rng.random(Be) < 0.6, rng.integers(0, C, Be), -1)
    emit[: min(2, Be)] = 3
    delta = np.where(emit >= 0, rng.integers(1, 11, Be), 0)
    wf, wl, we = jops.hit_metadata_update_op(
        jnp.asarray(freq), jnp.asarray(last), jnp.asarray(ext),
        jnp.asarray(hit.astype(np.int32)), jnp.asarray(hts),
        jnp.asarray(emit.astype(np.int32)),
        jnp.asarray(delta.astype(np.float32)))
    gf, gl, ge = ops.hit_metadata_update_op(
        _t(freq), _t(last), torch.tensor(ext), _t(hit), _t(hts), _t(emit),
        _t(delta))
    assert np.array_equal(gf.numpy(), np.asarray(wf).astype(np.int64))
    assert np.array_equal(gl.numpy(), np.asarray(wl).astype(np.int64))
    np.testing.assert_array_max_ulp(ge.numpy(), np.asarray(we), maxulp=4)


@pytest.mark.parametrize("seed,C,Bh,Be,case", [
    (0, 11, 7, 9, "mixed"), (1, 32, 33, 64, "mixed"), (2, 24, 1, 3, "mixed"),
    (3, 17, 40, 5, "mixed"), (4, 16, 32, 8, "one_slot"),
    (5, 16, 24, 24, "overlap")])
def test_hit_metadata_update_in_place_matches_pallas(seed, C, Bh, Be, case):
    """The in-place op on copies of the columns equals the JAX op: the
    seeds and shapes above, every hit on one slot, and flushes on exactly
    the hit slots (the FAA must not reach a slot before its ext update
    has read the step-entry freq)."""
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 2**32 - 64, C, dtype=np.uint64).astype(np.uint32)
    freq[:3] = [0, 1, 2**32 - 100]
    last = rng.integers(0, 5000, C).astype(np.uint32)
    ext = rng.uniform(0, 60, (C, 4)).astype(np.float32)
    hit = np.where(rng.random(Bh) < 0.75, rng.integers(0, C, Bh), -1)
    hit[: min(4, Bh)] = hit[0]
    if case == "one_slot":
        hit[:] = 2
    hts = (5000 + rng.integers(0, 8, Bh)).astype(np.uint32)
    emit = np.where(rng.random(Be) < 0.6, rng.integers(0, C, Be), -1)
    emit[: min(2, Be)] = 3
    if case == "overlap":
        emit = hit.copy()
    delta = np.where(emit >= 0, rng.integers(1, 11, Be), 0)
    wf, wl, we = jops.hit_metadata_update_op(
        jnp.asarray(freq), jnp.asarray(last), jnp.asarray(ext),
        jnp.asarray(hit.astype(np.int32)), jnp.asarray(hts),
        jnp.asarray(emit.astype(np.int32)),
        jnp.asarray(delta.astype(np.float32)))
    gf, gl, ge = _t(freq), _t(last), torch.tensor(ext)
    ops.hit_metadata_update_op_(gf, gl, ge, _t(hit), _t(hts), _t(emit),
                                _t(delta))
    assert np.array_equal(gf.numpy(), np.asarray(wf).astype(np.int64))
    assert np.array_equal(gl.numpy(), np.asarray(wl).astype(np.int64))
    np.testing.assert_array_max_ulp(ge.numpy(), np.asarray(we), maxulp=4)
    touched = np.unique(hit[hit >= 0])
    assert not np.array_equal(ge.numpy()[touched], ext[touched])
    if case == "overlap":
        assert np.array_equal(gf.numpy()[touched] > freq[touched].astype(
            np.int64), np.ones(touched.size, bool))


def test_hit_metadata_update_writes_fresh_tensors():
    """The eviction later in the step reads the step-entry columns."""
    freq, last = _t([1, 2, 3]), _t([10, 20, 30])
    ext = torch.zeros(3, 4)
    f2, l2, e2 = ops.hit_metadata_update_op(freq, last, ext, _t([1]),
                                            _t([40]), _t([2]), _t([5]))
    assert freq.tolist() == [1, 2, 3] and last.tolist() == [10, 20, 30]
    assert f2.tolist() == [1, 2, 8] and l2.tolist() == [10, 40, 30]
    assert bool((ext == 0).all()) and float(e2[1, 3]) == 20.0


# ---------------------------------------------------------------------------
# ranked_eviction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,C,B,W,K,experts,filt", [
    (0, 32, 9, 20, 5, ("lru", "lfu"), False),
    (1, 29, 16, 12, 4, EXPERTS, False),
    (2, 160, 7, 128, 5, EXPERTS, True),
    (3, 24, 33, 20, 5, ("hyperbolic", "size", "fifo"), True),
    (4, 11, 5, 11, 3, ("lfu",), False),
    (5, 300, 9, 132, 33, EXPERTS, True),
    (6, 260, 13, 128, 64, ("lru", "lfu"), False),
    (7, 90, 6, 64, 64, ("size", "hyperbolic"), False)])
def test_ranked_eviction_matches_pallas(seed, C, B, W, K, experts, filt):
    """K > 32 (a sample wider than one warp's lanes) with quotas that
    peel most of it."""
    rng = np.random.default_rng(seed)
    size = rng.choice([0, 1, 2, 3, 8, 255], C).astype(np.uint32)
    ins = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    ins[: C // 2] = rng.integers(0, 900, C // 2)      # small ages too
    last = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    freq = rng.integers(0, 50, C).astype(np.uint32)
    freq[:4] = freq[4]                                 # priority ties
    tenant = rng.integers(0, 3, C).astype(np.uint32)
    offs = rng.integers(0, C, B).astype(np.int32)
    ech = rng.integers(0, len(experts), B).astype(np.int32)
    must = rng.random(B) < 0.8
    quota = rng.integers(0, 5 if K <= 32 else 4 * K, B).astype(np.int32)
    ts = (1000 + rng.integers(0, 8, B)).astype(np.uint32)
    tfilt = np.where(rng.random(B) < 0.5, -1,
                     rng.integers(0, 3, B)).astype(np.int32)
    wrap = lambda x: jnp.asarray(np.concatenate([x, x[:W]]).astype(np.float32))
    wv, wc = jops.ranked_eviction_op(
        wrap(size), wrap(ins), wrap(last), wrap(freq), jnp.asarray(offs),
        jnp.asarray(ech), jnp.asarray(must), jnp.asarray(quota),
        jnp.asarray(ts), tenant=wrap(tenant) if filt else None,
        tfilt=jnp.asarray(tfilt) if filt else None, window=W, k=K,
        experts=experts)
    gv, gc = ops.ranked_eviction_op(
        _t(size), _t(ins), _t(last), _t(freq), _t(offs), _t(ech),
        torch.from_numpy(must), _t(quota), _t(ts), window=W, k=K,
        experts=experts, tenant=_t(tenant) if filt else None,
        tfilt=_t(tfilt) if filt else None)
    assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))
    assert int((gv >= 0).sum()) > 0


def test_ranked_eviction_scalar_quota_and_no_live_sample():
    size = _t([0, 255, 0, 1, 1, 0])
    z = torch.zeros(6, dtype=torch.int64)
    offs = _t([0, 4])
    v, c = ops.ranked_eviction_op(size, z, _t([5, 6, 7, 8, 9, 1]), z, offs,
                                  _t([0, 0]), torch.tensor([True, True]),
                                  torch.tensor(2), _t([3, 3]), window=2, k=2,
                                  experts=("lru",))
    assert v.tolist() == [[-1, -1], [4, -1]]   # op 1's window is slots 4, 5
    assert c.tolist() == [[0], [4]]            # no live sample: offset


def _jax_draw_and_eviction(size, ins, last, freq, keys, weights, must, quota,
                           ts, G, W, K, experts, tenant=None, tfilt=None,
                           op_tenant=None):
    """The cache step's draw, expert choice, Pallas eviction and bitmap as
    the JAX package's step computes them (``repro/core/cache.py:197-199``,
    ``:358``, ``:382``, ``:497-504``, ``:604-610``) on these inputs: keys
    u32[lanes, 2] tiled over G rounds, per-lane weights [lanes, E], or
    per-(lane, tenant) weights [lanes, T, E] with each op's tenant id
    ``op_tenant``; ``tenant`` [C] and ``tfilt`` [B] the sample filter.  An
    expert choice of E takes no victim, as the reference backend's NaN
    gather decides (the Pallas kernel would rank by expert 0; ROADMAP
    Queue 3)."""
    import jax
    lanes, E = keys.shape[0], len(experts)
    C = size.shape[0]
    rng_b = jnp.tile(jnp.asarray(keys, jnp.uint32), (G, 1))
    step_rng = jax.vmap(jax.random.fold_in)(rng_b, jnp.asarray(ts, jnp.uint32))
    u2 = jax.vmap(lambda r: jax.random.uniform(r, (2,)))(step_rng)
    lane_b = jnp.tile(jnp.arange(lanes, dtype=jnp.int32), G)
    w = jnp.asarray(weights)
    rows = (w[lane_b] if op_tenant is None
            else w[lane_b, jnp.asarray(op_tenant, jnp.int32)])
    e_choice = j_cache._choose_expert(rows, u2[:, 0])
    offs = jnp.minimum((u2[:, 1] * C).astype(jnp.int32), C - 1)
    wrap = lambda x: jnp.asarray(np.concatenate([x, x[:W]]).astype(np.float32))
    filt = {} if tenant is None else dict(tenant=wrap(tenant),
                                          tfilt=jnp.asarray(tfilt, jnp.int32))
    victims, cand = jops.ranked_eviction_op(
        wrap(size), wrap(ins), wrap(last), wrap(freq), offs, e_choice,
        jnp.asarray(must), jnp.asarray(quota), jnp.asarray(ts), window=W,
        k=K, experts=experts, **filt)
    victims = jnp.where((e_choice < E)[:, None], victims, -1)
    flat = victims.reshape(-1)
    cand_rep = jnp.repeat(cand, K, axis=0)
    e_rep = jnp.repeat(e_choice, K)
    bmap = jnp.sum(((cand_rep == flat[:, None]).astype(jnp.uint32)
                    << jnp.arange(E, dtype=jnp.uint32)[None, :]), axis=1)
    bmap = bmap | (jnp.uint32(1) << e_rep.astype(jnp.uint32))
    return tuple(np.asarray(x).astype(np.int64) for x in (
        victims, cand, e_choice, bmap.reshape(-1, K), offs))


@pytest.mark.parametrize("seed,C,lanes,G,W,K,experts,per_op,starved", [
    (0, 6 * 37, 4, 3, 20, 5, ("lru", "lfu"), True, False),
    (1, 6 * 40, 5, 2, 66, 33, EXPERTS, False, True),
    (2, 256, 3, 4, 128, 64, ("hyperbolic",), True, True),
    (3, 6 * 23, 8, 2, 20, 5, EXPERTS, False, False),
    (4, 300, 4, 2, 64, 64, ("lru", "lfu"), True, True),
    (5, 6 * 11, 2, 5, 40, 33, ("size",), False, False)])
def test_ranked_eviction_draw_matches_the_jax_step(seed, C, lanes, G, W, K,
                                                   experts, per_op, starved):
    """The draw form's plain version (what the fused step runs on the CPU)
    against the JAX step's threefry draw, expert choice, Pallas
    ranked_eviction and victim bitmap, bit for bit: K = 5, 33, 64; E = 1,
    2, 5; tables of 6·m slots (assoc 6, not a power of two); a scalar or
    per-op quota; ``starved``: lane 0's weights sum below 1e-30, so its
    cdf stays below u and the choice is E (no victim)."""
    from repro_torch.core import cache as t_cache
    rng = np.random.default_rng(seed)
    B, E = G * lanes, len(experts)
    size = rng.choice([0, 1, 2, 3, 8, 255], C).astype(np.uint32)
    ins = rng.integers(0, 900, C).astype(np.uint32)
    last = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    freq = rng.integers(0, 6, C).astype(np.uint32)        # priority ties
    keys = rng.integers(0, 2**32, (lanes, 2), dtype=np.uint64).astype(
        np.uint32)
    weights = rng.random((lanes, E)).astype(np.float32) + 1e-4
    if starved:
        weights[0] = 1e-32
    ts = np.repeat(1000 + np.arange(G), lanes).astype(np.uint32)
    ts[-lanes:] = 2**32 - 1 - np.arange(lanes)            # near the u32 top
    must = rng.random(B) < 0.85
    quota = (rng.integers(0, 4 * K, B) if per_op
             else np.asarray(rng.integers(1, 3 * K))).astype(np.int32)
    want = _jax_draw_and_eviction(size, ins, last, freq, keys, weights, must,
                                  quota, ts, G, W, K, experts)
    cdf = t_cache._expert_cdf(torch.from_numpy(weights))
    args = (_t(size), _t(ins), _t(last), _t(freq), _t(keys), cdf,
            torch.from_numpy(must), _t(quota), _t(ts))
    got = ops.ranked_eviction_draw_op(*args, window=W, k=K, experts=experts)
    offs, _ = ref.eviction_draw_ref(_t(keys), cdf, _t(ts), C)
    for name, g, w in zip(("victims", "cand", "e_choice", "bmap", "offsets"),
                          got + (offs,), want):
        assert np.array_equal(g.numpy(), w), name
    assert int((got[0] >= 0).sum()) > 0
    assert bool((got[2] == E).any()) == starved
    assert bool((got[2][got[2] < E] >= 0).all())


@pytest.mark.parametrize("seed,C,lanes,G,W,K,Tn,experts", [
    (6, 6 * 37, 4, 3, 20, 5, 3, ("lru", "lfu")),
    (7, 300, 5, 2, 66, 33, 2, EXPERTS),
    (8, 256, 3, 4, 128, 64, 4, ("hyperbolic", "lfu")),
    (9, 6 * 23, 8, 2, 40, 5, 2, ("size",))])
def test_ranked_eviction_draw_with_tenants_matches_the_jax_step(
        seed, C, lanes, G, W, K, Tn, experts):
    """The draw form's tenant case (the multi-tenant step's): each op's
    expert choice from its (lane, tenant) weights, ``_choose_expert(
    local_w[lane_b, tb_i], u)`` of the JAX step, and its sample scoped by
    the tenant filter (-1 unfiltered), against the JAX step's draw and
    Pallas ``ranked_eviction_op(..., tenant=, tfilt=)``, bit for bit; the
    (lane, tenant) row of lane 0, tenant 1 sums below 1e-30 (choice E).
    Filtered ops claim only their tenant's slots.  Then the untenanted
    form is the tenant form with one tenant, bit for bit."""
    from repro_torch.core import cache as t_cache
    rng = np.random.default_rng(seed)
    B, E = G * lanes, len(experts)
    size = rng.choice([0, 1, 2, 3, 8, 255], C).astype(np.uint32)
    ins = rng.integers(0, 900, C).astype(np.uint32)
    last = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    freq = rng.integers(0, 6, C).astype(np.uint32)
    tenant = rng.integers(0, Tn, C).astype(np.uint32)
    keys = rng.integers(0, 2**32, (lanes, 2), dtype=np.uint64).astype(
        np.uint32)
    weights = rng.random((lanes, Tn, E)).astype(np.float32) + 1e-4
    weights[0, 1] = 1e-32
    op_tenant = rng.integers(0, Tn, B)
    op_tenant[0] = 1
    tfilt = np.where(rng.random(B) < 0.5, -1, op_tenant)
    ts = np.repeat(1000 + np.arange(G), lanes).astype(np.uint32)
    must = rng.random(B) < 0.85
    quota = rng.integers(0, 4 * K, B).astype(np.int32)
    want = _jax_draw_and_eviction(size, ins, last, freq, keys, weights, must,
                                  quota, ts, G, W, K, experts, tenant=tenant,
                                  tfilt=tfilt, op_tenant=op_tenant)
    cdf = t_cache._expert_cdf(torch.from_numpy(weights))    # [lanes, T, E]
    args = (_t(size), _t(ins), _t(last), _t(freq), _t(keys), cdf,
            torch.from_numpy(must), _t(quota), _t(ts))
    kw = dict(window=W, k=K, experts=experts)
    got = ops.ranked_eviction_draw_op(*args, **kw, tenant=_t(tenant),
                                      tfilt=_t(tfilt),
                                      op_tenant=_t(op_tenant))
    offs, _ = ref.eviction_draw_ref(_t(keys), cdf, _t(ts), C, _t(op_tenant))
    for name, g, w in zip(("victims", "cand", "e_choice", "bmap", "offsets"),
                          got + (offs,), want):
        assert np.array_equal(g.numpy(), w), name
    v = got[0].numpy()
    assert (v >= 0).sum() > 0 and int(got[2][0]) == E
    for b in np.nonzero(tfilt >= 0)[0]:
        assert (tenant[v[b][v[b] >= 0]] == tfilt[b]).all(), b
    one = ops.ranked_eviction_draw_op(*args[:5], cdf[:, -1].contiguous(),
                                      *args[6:], **kw)
    as_tenant = ops.ranked_eviction_draw_op(
        *args[:5], cdf[:, -1:].contiguous(), *args[6:], **kw,
        op_tenant=_t(np.zeros(B)))
    for a, b in zip(one, as_tenant):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# sampled_eviction, bucket_lookup, metadata_update: the kernels.ops entry
# point's own three, on tests/test_kernels.py's shapes, experts and seeds
# ---------------------------------------------------------------------------

SEEDS = [11 * i + 3 for i in range(10)]


def _f(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _eviction_table(rng, C, W, live_frac=0.4):
    """tests/test_kernels.py's table: f32 columns padded by W at the tail
    (sizes there stay 0: empty slots)."""
    size = np.zeros(C + W, np.float32)
    n_live = int(C * live_frac)
    idx = rng.choice(C, n_live, replace=False)
    size[idx] = rng.integers(1, 9, n_live)
    ins = rng.integers(0, 1000, C + W).astype(np.float32)
    last = rng.integers(0, 1000, C + W).astype(np.float32)
    freq = rng.integers(1, 50, C + W).astype(np.float32)
    return size, ins, last, freq


@pytest.mark.parametrize("C,W,B,experts", [
    (512, 20, 8, ("lru", "lfu")),
    (2048, 20, 32, ("lru", "lfu")),
    (2048, 12, 16, ("lru", "lfu", "fifo", "size")),
    (4096, 24, 64, ("hyperbolic", "lfu")),
    (1024, 128, 16, EXPERTS),
])
def test_sampled_eviction_matches_pallas(rng, C, W, B, experts):
    size, ins, last, freq = _eviction_table(rng, C, W)
    freq[: C // 2] = 7.0                        # priority ties
    offs = rng.integers(0, C, B).astype(np.int32)
    offs[-1] = C                                # a window in the empty tail
    choice = rng.integers(0, len(experts), B).astype(np.int32)
    wv, wc = jops.sampled_eviction_op(size, ins, last, freq, offs, choice,
                                      1000.0, window=W, experts=experts)
    gv, gc = ops.sampled_eviction_op(_f(size), _f(ins), _f(last), _f(freq),
                                     _t(offs), _t(choice), 1000.0, window=W,
                                     experts=experts)
    assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))
    assert gv[-1] == -1 and (gc[-1] == -1).all()
    assert int((gv >= 0).sum()) > B // 2


@pytest.mark.parametrize("C,W,B,k", [(1024, 128, 16, 33), (512, 64, 8, 64),
                                     (2048, 132, 24, 64)])
def test_sampled_eviction_wide_sample_matches_pallas(rng, C, W, B, k):
    """K > 32: a sample wider than one warp's lanes."""
    size, ins, last, freq = _eviction_table(rng, C, W, live_frac=0.6)
    freq[: C // 2] = 7.0                        # priority ties
    offs = rng.integers(0, C, B).astype(np.int32)
    offs[-1] = C                                # a window in the empty tail
    choice = rng.integers(0, len(EXPERTS), B).astype(np.int32)
    wv, wc = jops.sampled_eviction_op(size, ins, last, freq, offs, choice,
                                      1000.0, window=W, k=k, experts=EXPERTS)
    gv, gc = ops.sampled_eviction_op(_f(size), _f(ins), _f(last), _f(freq),
                                     _t(offs), _t(choice), 1000.0, window=W,
                                     k=k, experts=EXPERTS)
    assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))
    assert int((gv >= 0).sum()) > B // 2


def test_sampled_eviction_empty_table(rng):
    C, W, B = 512, 20, 8
    size = np.zeros(C + W, np.float32)  # nothing live
    ins = last = freq = np.ones(C + W, np.float32)
    offs = rng.integers(0, C, B).astype(np.int32)
    choice = np.zeros(B, np.int32)
    wv, wc = jops.sampled_eviction_op(size, ins, last, freq, offs, choice,
                                      10.0)
    gv, gc = ops.sampled_eviction_op(_f(size), _f(ins), _f(last), _f(freq),
                                     _t(offs), _t(choice), torch.tensor(10.0))
    assert (gv == -1).all() and (gc == -1).all()
    assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))


@pytest.mark.parametrize("seed,C,W,B,k", [(0, 300, 20, 13, 5),
                                          (1, 97, 40, 5, 32)])
def test_sampled_eviction_odd_batch_matches_the_jnp_oracle(seed, C, W, B, k):
    """B % 8 != 0, which the Pallas kernel refuses: against its oracle."""
    rng = np.random.default_rng(seed)
    size, ins, last, freq = _eviction_table(rng, C, W, live_frac=0.6)
    offs = rng.integers(0, C + 1, B).astype(np.int32)
    choice = rng.integers(0, len(EXPERTS), B).astype(np.int32)
    wv, wc = jref.sampled_eviction_ref(
        jnp.asarray(size), jnp.asarray(ins), jnp.asarray(last),
        jnp.asarray(freq), jnp.asarray(offs), jnp.asarray(choice), 990.0,
        window=W, k=k, experts=EXPERTS)
    gv, gc = ops.sampled_eviction_op(_f(size), _f(ins), _f(last), _f(freq),
                                     _t(offs), _t(choice), 990.0, window=W,
                                     k=k, experts=EXPERTS)
    assert np.array_equal(gv.numpy(), np.asarray(wv).astype(np.int64))
    assert np.array_equal(gc.numpy(), np.asarray(wc).astype(np.int64))


def test_sampled_eviction_out_of_range_choice_and_positions():
    """The port's rules where the JAX op leaves the result undefined: an
    expert choice outside [0, E) takes no victim, and a window position
    past the columns reads as an empty slot."""
    col = _f([0, 3, 1, 2, 5])
    v, c = ops.sampled_eviction_op(col, col, col, _f([0, 1, 9, 0, 0]),
                                   _t([1, 1, 3]), _t([2, -1, 0]), 9.0,
                                   window=3, k=2)
    assert c.tolist() == [[2, 1], [2, 1], [3, 3]]
    assert v.tolist() == [-1, -1, 3]


@pytest.mark.parametrize("C,A,B", [(512, 8, 16), (4096, 8, 32), (1024, 4, 8),
                                   (515, 8, 13), (2048, 16, 24),
                                   (2063, 16, 13)])
def test_bucket_lookup_matches_pallas(rng, C, A, B):
    """tests/test_kernels.py's planted table; C = 515 leaves a ragged
    tail (floor(C / A) buckets) and B = 13 is odd."""
    tk = np.zeros(C, np.uint32)
    tsz = np.zeros(C, np.uint32)
    put = rng.integers(1, 1 << 31, 300).astype(np.uint32)
    hs = np.asarray(j_hash_key(jnp.asarray(put)))
    bs = hs % (C // A)
    placed = []
    for k, b in zip(put, bs):
        for a in range(A):
            s = b * A + a
            if tsz[s] == 0:
                tk[s] = k
                tsz[s] = rng.choice([1, 255])   # live or a history entry
                placed.append(k)
                break
    q = np.concatenate([np.array(placed[:B // 2], np.uint32),
                        rng.integers(1, 1 << 31, B - B // 2).astype(np.uint32)])
    q[-1] = q[0]                                # a duplicate
    wf, ws = jops.bucket_lookup_op(tk, tsz, q, assoc=A)
    gf, gs = ops.bucket_lookup_op(_t(tk), _t(tsz), _t(q), assoc=A)
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert np.array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
    assert int(gf.sum()) >= 1 and int((gs == -1).sum()) >= B - B // 2 - 1


def test_bucket_lookup_odd_batch(rng):
    C, A, B = 512, 8, 11
    q = rng.integers(1, 1 << 31, B).astype(np.uint32)
    z = np.zeros(C, np.uint32)
    wf, ws = jops.bucket_lookup_op(z, z, q, assoc=A)
    gf, gs = ops.bucket_lookup_op(_t(z), _t(z), _t(q), assoc=A)
    assert gf.shape == (B,) and not gf.any() and (gs == -1).all()
    assert np.array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))


def _sequential_update(freq, last, slots, deltas, clock):
    """freq + d_1 + d_2 + ... in f32, one entry at a time, in batch order."""
    freq, last = freq.copy(), last.copy()
    for s, d in zip(slots, deltas):
        if 0 <= s < freq.shape[0]:
            freq[s] = np.float32(freq[s] + d)
            last[s] = max(last[s], np.float32(clock))
    return freq, last


@pytest.mark.parametrize("seed", SEEDS)
def test_metadata_update_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    C, B = 1024, 32
    freq = rng.integers(0, 100, C).astype(np.float32)
    last = rng.integers(0, 100, C).astype(np.float32)
    slots = rng.integers(-1, C, B).astype(np.int32)  # includes no-ops & dups
    slots[1:4] = slots[0]
    deltas = rng.integers(1, 10, B).astype(np.float32)
    wf, wl = jops.metadata_update_op(freq, last, slots, deltas, 777.0)
    gf, gl = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    777.0)
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert np.array_equal(gl.numpy(), np.asarray(wl))
    assert gf.data_ptr() != 0 and freq.sum() != gf.sum()   # fresh, updated

    # Non-integer deltas: within rtol 1e-6 of the Pallas kernel (which sums
    # a slot's deltas first), bit-equal to adding them one by one in order.
    deltas = (rng.random(B) * 10).astype(np.float32)
    freq = (freq + rng.random(C).astype(np.float32)).astype(np.float32)
    wf, wl = jops.metadata_update_op(freq, last, slots, deltas, 777.5)
    gf, gl = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    torch.tensor(777.5))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-6)
    assert np.array_equal(gl.numpy(), np.asarray(wl))
    sf, sl = _sequential_update(freq, last, slots, deltas, 777.5)
    assert np.array_equal(gf.numpy(), sf) and np.array_equal(gl.numpy(), sl)


def test_metadata_update_combines_duplicates():
    freq = np.zeros(512, np.float32)
    last = np.zeros(512, np.float32)
    slots = np.array([7, 7, 7, -1, 9, 9, 3, 3], np.int32)
    deltas = np.ones(8, np.float32)
    wf, wl = jops.metadata_update_op(freq, last, slots, deltas, 5.0)
    f2, l2 = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    5.0)
    assert float(f2[7]) == 3 and float(f2[9]) == 2 and float(f2[3]) == 2
    assert float(l2[7]) == 5.0 and float(l2[0]) == 0.0
    assert np.array_equal(f2.numpy(), np.asarray(wf))
    assert np.array_equal(l2.numpy(), np.asarray(wl))


def _jax_updates(freq, last, slots, deltas, clock):
    """The Pallas op's and repro/kernels/ref.py's metadata_update_ref's
    (freq, last_ts)."""
    return (jops.metadata_update_op(freq, last, slots, deltas, clock),
            jref.metadata_update_ref(jnp.asarray(freq), jnp.asarray(last),
                                     jnp.asarray(slots), jnp.asarray(deltas),
                                     clock))


@pytest.mark.parametrize("case", ["one_slot", "pairs"])
def test_metadata_update_repeated_slots_match_both_jax_functions(case):
    """Integer deltas on the shapes the CUDA kernel's combine must meet:
    all 2048 entries on one slot (one chain of adds), and every slot
    twice, B / 2 entries apart.  Bit-equal to the Pallas op and to its
    jnp oracle."""
    rng = np.random.default_rng(21)
    C, B = 4096, 2048
    freq = rng.integers(0, 100, C).astype(np.float32)
    last = rng.integers(0, 100, C).astype(np.float32)
    if case == "one_slot":
        slots = np.full(B, 517, np.int32)
    else:
        slots = np.tile(rng.choice(C, B // 2, replace=False), 2)
    slots = slots.astype(np.int32)
    deltas = rng.integers(0, 10, B).astype(np.float32)
    gf, gl = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    777.0)
    for wf, wl in _jax_updates(freq, last, slots, deltas, 777.0):
        assert np.array_equal(gf.numpy(), np.asarray(wf))
        assert np.array_equal(gl.numpy(), np.asarray(wl))
    if case == "one_slot":
        assert float(gf[517]) == freq[517] + deltas.sum()
        assert float(gl[517]) == 777.0


def test_metadata_update_one_slot_adds_non_integer_deltas_in_order():
    """All 2048 non-integer deltas on one slot: bit-equal to adding them
    one by one in batch order, and within rtol 1e-6 of the Pallas op
    (which may sum a slot's deltas before adding them)."""
    rng = np.random.default_rng(23)
    C, B = 1024, 2048
    freq = (rng.integers(0, 100, C) + rng.random(C)).astype(np.float32)
    last = rng.integers(0, 100, C).astype(np.float32)
    slots = np.full(B, 7, np.int32)
    deltas = (rng.random(B) * 10).astype(np.float32)
    gf, gl = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    777.5)
    sf, sl = _sequential_update(freq, last, slots, deltas, 777.5)
    assert np.array_equal(gf.numpy(), sf) and np.array_equal(gl.numpy(), sl)
    wf, wl = jops.metadata_update_op(freq, last, slots, deltas, 777.5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-6)
    assert np.array_equal(gl.numpy(), np.asarray(wl))


def test_metadata_update_tile_is_the_kernels():
    """The tile that the card tests and chip_smoke.py place entries by
    is the CUDA kernel's own."""
    from repro_torch.kernels.metadata_update import TILE
    src = (runtime.CSRC / "metadata_update.cu").read_text()
    assert re.search(r"constexpr int TILE = (\d+);", src).group(1) == str(TILE)


@pytest.mark.parametrize("seed,C,B", [(0, 777, 13), (1, 5, 40)])
def test_metadata_update_any_table_matches_the_jnp_oracle(seed, C, B):
    """C % 512 != 0, which the Pallas kernel refuses, slots past C and a
    zero delta (its slot's last_ts still moves): against its oracle."""
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 100, C).astype(np.float32)
    last = rng.integers(0, 100, C).astype(np.float32)
    slots = rng.integers(-1, C + 3, B).astype(np.int32)
    deltas = rng.integers(0, 10, B).astype(np.float32)
    deltas[0] = 0.0
    wf, wl = jref.metadata_update_ref(jnp.asarray(freq), jnp.asarray(last),
                                      jnp.asarray(slots), jnp.asarray(deltas),
                                      150.0)
    gf, gl = ops.metadata_update_op(_f(freq), _f(last), _t(slots), _f(deltas),
                                    150.0)
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert np.array_equal(gl.numpy(), np.asarray(wl))


# ---------------------------------------------------------------------------
# drop_scatter (the apply's writes; XLA's in-place scatter in the JAX package)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,B,W,case", [
    (0, 9, 6, 2, "mixed"), (1, 32, 40, 4, "mixed"), (2, 5, 4, 1, "none"),
    (3, 16, 16, 3, "all"), (4, 7, 1, 2, "mixed")])
def test_drop_scatter_matches_xla_drop_mode(seed, n, B, W, case):
    """Several columns to one index array against ``.at[idx].set(src,
    mode="drop")``: index n (the step's dropped index) and -1 write
    nothing, duplicates write equal rows, a number fills an int64
    column."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, B)
    idx[rng.random(B) < 0.3] = n
    if case == "none":
        idx[:] = n
        idx[0] = -1
    elif case == "all":
        idx = rng.permutation(n)[:B]
    if B > 3 and case == "mixed":
        idx[2] = idx[0]                       # a duplicate, equal rows
    a = rng.integers(0, 2**32, n).astype(np.uint32)
    b = rng.random((n, W)).astype(np.float32)
    c = rng.integers(0, 2**32, (n, W)).astype(np.uint32)
    src_a = rng.integers(0, 2**32, B).astype(np.uint32)
    src_b = rng.random((B, W)).astype(np.float32)
    first = np.unique(idx, return_index=True, return_inverse=True)
    src_a, src_b = src_a[first[1]][first[2]], src_b[first[1]][first[2]]
    ji = jnp.asarray(np.where(idx < 0, n, idx).astype(np.int32))
    want = (jnp.asarray(a).at[ji].set(jnp.asarray(src_a), mode="drop"),
            jnp.asarray(b).at[ji].set(jnp.asarray(src_b), mode="drop"),
            jnp.asarray(c).at[ji].set(jnp.uint32(7), mode="drop"))
    got = (_t(a), torch.tensor(b), _t(c))
    ops.drop_scatter_op_(_t(idx), got, (_t(src_a), torch.tensor(src_b), 7))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    if case == "none":
        assert np.array_equal(got[0].numpy(), a)


def test_drop_scatter_writes_nothing_at_the_dropped_index():
    col = _t([10, 11, 12])
    ops.drop_scatter_op_(_t([3, 3, -1]), (col,), (_t([1, 2, 3]),))
    assert col.tolist() == [10, 11, 12]
    ops.drop_scatter_op_(_t([3, 0, 3]), (col,), (_t([1, 2, 3]),))
    assert col.tolist() == [2, 11, 12]
    with pytest.raises(TypeError, match="integer"):
        ops.drop_scatter_op_(_t([0]), (torch.zeros(3),), (1,))
    with pytest.raises(ValueError, match="columns"):
        ops.drop_scatter_op_(_t([0]), (col,), ())
    with pytest.raises(ValueError, match="shape"):
        ops.drop_scatter_op_(_t([0]), (col, _t([1, 2])), (1, 2))


@pytest.mark.parametrize("seed,n,B,case", [
    (0, 12, 9, "mixed"), (1, 40, 33, "mixed"), (2, 7, 5, "all_dropped"),
    (3, 16, 16, "one_slot")])
def test_drop_scatter_groups_match_xla_group_by_group(seed, n, B, case):
    """Three write groups in one call against ``.at[idx].set(src,
    mode="drop")`` applied group by group in JAX: a later group's write
    of a (slot, column) wins over an earlier one's, a masked entry writes
    nothing, an all-dropped group writes nothing, and a ``(cond, a, b)``
    source writes ``a`` where ``cond`` holds, else ``b``."""
    rng = np.random.default_rng(seed)
    W = 2
    cols = (rng.integers(0, 2**32, n).astype(np.uint32),
            rng.random((n, W)).astype(np.float32),
            rng.integers(0, 2**32, (n, W)).astype(np.uint32))
    got = (_t(cols[0]), torch.from_numpy(cols[1].copy()), _t(cols[2]))
    want = [jnp.asarray(c) for c in cols]
    groups, kept = [], []
    for g in range(3):
        # Unique in-range indices within the group, the rest out of range.
        idx = rng.permutation(n + B)[:B].astype(np.int64)
        idx[rng.random(B) < 0.2] = -1
        mask = rng.random(B) < 0.7
        if case == "one_slot":                  # every group writes slot 3
            idx[:] = n
            idx[g], mask[g] = 3, True
        if case == "all_dropped" and g == 1:
            idx[:] = np.where(rng.random(B) < 0.5, n, -1)
        cond = rng.random(B) < 0.5
        a = rng.integers(0, 2**32, B).astype(np.uint32)
        b = rng.random((B, W)).astype(np.float32)
        c = rng.integers(0, 2**32, (B, W)).astype(np.uint32)
        keep = (idx >= 0) & (idx < n) & (mask if g else True)
        kept.append(set(idx[keep].tolist()))
        ji = jnp.asarray(np.where(keep, idx, n).astype(np.int32))
        want = [w.at[ji].set(jnp.asarray(x), mode="drop") for w, x in zip(
            want, (np.where(cond, a, 9), b, np.where(cond[:, None], 5, c)))]
        tc = torch.from_numpy(cond)
        groups.append((_t(idx), got, ((tc, _t(a), 9), torch.from_numpy(b),
                                      (tc, 5, _t(c))))
                      + ((torch.from_numpy(mask),) if g else ()))
    ops.drop_scatter_groups_op_(groups)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    if case == "all_dropped":
        assert not kept[1]
    else:                                       # collisions across groups
        assert kept[0] & kept[1] or kept[1] & kept[2] or kept[0] & kept[2]


def test_drop_scatter_groups_check_their_arguments():
    col = _t([1, 2, 3])
    one = (_t([0]), (col,), (_t([7]),))
    with pytest.raises(ValueError, match="groups"):
        ops.drop_scatter_groups_op_(())
    with pytest.raises(ValueError, match="groups"):
        ops.drop_scatter_groups_op_((one,) * 5)
    with pytest.raises(ValueError, match="in all"):
        ops.drop_scatter_groups_op_(((_t([0]), (col,) * 12, (1,) * 12),
                                     (_t([0]), (col,) * 5, (1,) * 5)))
    with pytest.raises(TypeError, match="cond"):
        ops.drop_scatter_op_(_t([0]), (col,), ((torch.ones(1).bool(), 1),))
    with pytest.raises(TypeError, match="tensor or an integer"):
        ops.drop_scatter_op_(_t([0]), (col,), ((torch.ones(1).bool(), 1,
                                                (torch.ones(1).bool(), 1,
                                                 2)),))
    with pytest.raises(TypeError, match="bool"):
        ops.drop_scatter_op_(_t([0]), (col,), (_t([7]),), _t([1]))
    ops.drop_scatter_op_(_t([0, 2]), (col,), ((torch.tensor([True, False]),
                                              _t([8, 8]), 4),),
                         torch.tensor([True, True]))
    assert col.tolist() == [8, 2, 4]


# ---------------------------------------------------------------------------
# the op wrappers
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launches()
    ops.hit_metadata_update_op(_t([0, 0]), _t([0, 0]), torch.zeros(2, 4),
                               _t([1]), _t([3]), _t([-1]), _t([0]))
    q = torch.zeros(1, 3, 2, 32)
    ops.flash_attention_op(q, q, q)
    col = torch.ones(8)
    ops.sampled_eviction_op(col, col, col, col, _t([0]), _t([0]), 1.0,
                            window=4, k=2)
    ops.bucket_lookup_op(_t([0] * 8), _t([0] * 8), _t([1]), assoc=4)
    ops.metadata_update_op(col, col, _t([3]), torch.ones(1), 2.0)
    ops.hit_metadata_update_op_(_t([0, 0]), _t([0, 0]), torch.zeros(2, 4),
                                _t([1]), _t([3]), _t([-1]), _t([0]))
    ops.drop_scatter_op_(_t([1, 2]), (_t([0, 0]),), (_t([5, 6]),))
    ops.drop_scatter_groups_op_(((_t([1]), (_t([0, 0]),), (3,)),
                                 (_t([0]), (_t([0]),), (4,),
                                  torch.tensor([True]))))
    z = _t([0] * 8)
    ops.access_probe_op(z, z, z, z, _t([1]), torch.tensor(0), assoc=4,
                        history_len=8, meta=(z, z, z), ts=_t([1]),
                        experts=("lru",))
    ops.ranked_eviction_draw_op(z, z, z, z, _t([[1, 2]]), torch.ones(1, 1),
                                torch.tensor([True]), torch.tensor(1),
                                _t([3]), window=4, k=2, experts=("lru",))
    assert ops.launches() == {"access_probe": 0, "hit_metadata_update": 0,
                              "ranked_eviction": 0, "flash_attention": 0,
                              "sampled_eviction": 0, "bucket_lookup": 0,
                              "metadata_update": 0, "drop_scatter": 0}


def test_wrappers_check_their_arguments():
    good = (_t([0, 0]), _t([0, 0]), torch.zeros(2, 4), _t([1]), _t([3]),
            _t([-1]), _t([0]))
    bad_dtype = (good[0].int(),) + good[1:]
    bad_shape = good[:2] + (torch.zeros(2, 3),) + good[3:]
    bad_layout = good[:2] + (torch.zeros(4, 2).t(),) + good[3:]
    for args, exc in ((bad_dtype, TypeError), (bad_shape, ValueError),
                      (bad_layout, ValueError)):
        with pytest.raises(exc):
            ops.hit_metadata_update_op(*args)
    meta = tuple(t.to("meta") for t in good)
    with pytest.raises(ValueError, match="no kernel"):
        ops.hit_metadata_update_op(*meta)
    z = _t([1, 1])
    with pytest.raises(ValueError, match="supports"):
        ops.ranked_eviction_op(z, z, z, z, _t([0]), _t([0]),
                               torch.tensor([True]), torch.tensor(1), _t([1]),
                               window=2, k=1, experts=("lrfu",))
    with pytest.raises(ValueError, match="multiple of assoc"):
        ops.access_probe_op(_t([0] * 6), _t([0] * 6), _t([0] * 6),
                            _t([0] * 6), _t([1]), torch.tensor(0), assoc=4,
                            history_len=8)
    assert KERNEL_EXPERTS == jops.KERNEL_EXPERTS

    col, one = torch.ones(8), _t([0])
    with pytest.raises(TypeError):          # u32 columns are not f32
        ops.sampled_eviction_op(_t([1] * 8), col, col, col, one, one, 1.0,
                                window=4)
    with pytest.raises(ValueError, match="supports"):
        ops.sampled_eviction_op(col, col, col, col, one, one, 1.0,
                                window=4, experts=("lrfu",))
    with pytest.raises(ValueError, match="window"):
        ops.sampled_eviction_op(col, col, col, col, one, one, 1.0, window=9)
    with pytest.raises(ValueError, match="k="):    # k > window
        ops.sampled_eviction_op(col, col, col, col, one, one, 1.0, window=8,
                                k=9)
    with pytest.raises(ValueError, match="k="):
        ops.ranked_eviction_op(z, z, z, z, _t([0]), _t([0]),
                               torch.tensor([True]), torch.tensor(1), _t([1]),
                               window=2, k=3, experts=("lru",))
    with pytest.raises(TypeError, match="clock"):
        ops.sampled_eviction_op(col, col, col, col, one, one,
                                torch.tensor(1), window=4)
    with pytest.raises(ValueError, match="clock"):
        ops.metadata_update_op(col, col, one, torch.ones(1),
                               torch.ones(1))
    with pytest.raises(TypeError, match="clock"):
        ops.metadata_update_op(col, col, one, torch.ones(1), "1")
    with pytest.raises(TypeError, match="deltas"):
        ops.metadata_update_op(col, col, one, _t([1]), 1.0)
    with pytest.raises(ValueError, match="assoc"):
        ops.bucket_lookup_op(_t([0] * 3), _t([0] * 3), _t([1]), assoc=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bucket_lookup_op(_t([0] * 16)[::2], _t([0] * 8), _t([1]),
                             assoc=4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.metadata_update_op(col.to("meta"), col.to("meta"),
                               one.to("meta"), torch.ones(1, device="meta"),
                               1.0)


def test_ranked_eviction_draw_checks_its_arguments():
    z, one = _t([1] * 6), torch.tensor([True, False])
    rng, cdf = _t([[1, 2], [3, 4]]), torch.ones(2, 2)
    good = (z, z, z, z, rng, cdf, one, torch.tensor(1), _t([7, 8]))
    kw = dict(window=4, k=2, experts=("lru", "lfu"))
    v, c, e, bm = ops.ranked_eviction_draw_op(*good, **kw)
    assert v.shape == bm.shape == (2, 2) and c.shape == (2, 2)
    assert e.shape == (2,)
    assert bool(((bm >> e[:, None]) & 1).all())   # the chosen expert's bit
    for i, bad, exc, match in (
            (4, _t([1, 2]), ValueError, "rng"),              # not [lanes, 2]
            (4, _t([[1, 2, 3]]), ValueError, "rng"),
            (4, _t([[1, 2]]).int(), TypeError, "rng"),
            (5, torch.ones(2, 3), ValueError, "cdf"),        # E columns
            (5, torch.ones(3, 2), ValueError, "cdf"),        # a row a lane
            (5, torch.ones(2, 2).double(), TypeError, "cdf"),
            (6, _t([1, 0]), TypeError, "must_evict"),
            (7, _t([1, 2, 3]), ValueError, "quota"),
            (8, _t([[7], [8]]), ValueError, "ts")):
        args = good[:i] + (bad,) + good[i + 1:]
        with pytest.raises(exc, match=match):
            ops.ranked_eviction_draw_op(*args, **kw)
    with pytest.raises(ValueError, match="lane"):
        ops.ranked_eviction_draw_op(*good[:4], _t(np.zeros((0, 2))),
                                    torch.ones(0, 2), *good[6:], **kw)
    with pytest.raises(ValueError, match="k="):
        ops.ranked_eviction_draw_op(*good, window=4, k=5,
                                    experts=("lru", "lfu"))
    with pytest.raises(ValueError, match="1 to 8 experts"):
        ops.ranked_eviction_draw_op(*good[:5], torch.ones(2, 9), *good[6:],
                                    window=4, k=2, experts=("lru",) * 9)
    with pytest.raises(ValueError, match="1 to 8 experts"):
        ops.ranked_eviction_op(z, z, z, z, _t([0]), _t([0]),
                               torch.tensor([True]), torch.tensor(1), _t([1]),
                               window=2, k=1, experts=())
    with pytest.raises(ValueError, match="no kernel"):
        ops.ranked_eviction_draw_op(*(t.to("meta") for t in good), **kw)
    # The tenant case: a [lanes, T, E] cdf with each op's tenant id, and
    # the sample filter's column and per-op ids, together.
    cdf3 = torch.ones(2, 3, 2)
    ot = _t([2, 0])
    v3 = ops.ranked_eviction_draw_op(*good[:5], cdf3, *good[6:], **kw,
                                     op_tenant=ot, tenant=z, tfilt=_t([-1, 1]))
    assert v3[0].shape == (2, 2)
    for bad, exc, match in (
            (dict(op_tenant=ot), ValueError, "cdf"),      # a [lanes, E] cdf
            (dict(cdf=cdf3), ValueError, "cdf"),          # no op_tenant
            (dict(cdf=cdf3, op_tenant=_t([1, 2, 0])), ValueError,
             "op_tenant"),
            (dict(cdf=cdf3, op_tenant=ot.int()), TypeError, "op_tenant"),
            (dict(cdf=torch.ones(2, 0, 2), op_tenant=ot), ValueError,
             "tenant"),
            (dict(tenant=z), ValueError, "together"),
            (dict(tenant=_t([1] * 5), tfilt=_t([0, 0])), ValueError,
             "tenant"),
            (dict(tenant=z, tfilt=_t([0])), ValueError, "tfilt")):
        args = good[:5] + (bad.pop("cdf", cdf),) + good[6:]
        with pytest.raises(exc, match=match):
            ops.ranked_eviction_draw_op(*args, **kw, **bad)


def test_each_cuda_source_carries_its_note_and_entry_point():
    srcs = {p.stem: p.read_text() for p in runtime.sources()}
    assert set(srcs) == {"access_probe", "hit_metadata_update",
                         "ranked_eviction", "flash_attention",
                         "sampled_eviction", "bucket_lookup",
                         "metadata_update", "drop_scatter", "launch_floor"}
    # The launch floor is the empty yardstick kernel: no path, no counter.
    assert set(srcs) == set(runtime.KERNELS) | {runtime.FLOOR}
    for name, text in srcs.items():
        assert f"extern \"C\" int {name}_launch(" in text
        # drop_scatter stands for XLA's in-place scatters, not a Pallas
        # kernel, and the floor stands for nothing.
        assert ("replaces no Pallas kernel"
                if name in ("drop_scatter", runtime.FLOOR)
                else "Replaces the Pallas kernel") in text
        assert "Bound on the H100" in text
        assert "cudaGetLastError()" in text
    # ranked_eviction.cu has a second entry point: the form that draws
    # each op's offset and expert choice itself.
    assert 'extern "C" int ranked_eviction_draw_launch(' in srcs[
        "ranked_eviction"]
    assert set(runtime.SIGNATURES) == ({f"{n}_launch" for n in srcs}
                                       | {"ranked_eviction_draw_launch"})
    assert "--use_fast_math" not in runtime.FLAGS
    assert re.search(r"compute_90a,code=sm_90a", " ".join(runtime.ARCH))
    assert Path(runtime.BUILD_DIR).name == "_build"


_LOCK_CHILD = r'''
import os, sys, time
from pathlib import Path
from repro_torch.kernels import runtime
build_dir, log = Path(sys.argv[1]), Path(sys.argv[2])
Path(sys.argv[3]).touch()                  # ready
while not Path(sys.argv[4]).exists():      # go: both at once
    time.sleep(0.005)
with runtime.build_lock(build_dir):
    with open(log, "a") as f:
        f.write(f"start {os.getpid()}\n")
    time.sleep(0.4)
    with open(log, "a") as f:
        f.write(f"end {os.getpid()}\n")
'''


def test_build_lock_keeps_two_builders_apart(tmp_path):
    """Two processes that reach the builder's lock at once hold it one
    after the other: the log holds one builder's start and end, then the
    other's, never interleaved."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(Path(runtime.__file__).parents[2]))
    log, go = tmp_path / "log", tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOCK_CHILD, str(tmp_path / "_build"),
         str(log), str(tmp_path / f"ready{i}"), str(go)], env=env)
        for i in range(2)]
    deadline = time.time() + 60
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.time() < deadline, "the builders did not start"
        time.sleep(0.01)
    go.touch()
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    lines = [ln.split() for ln in log.read_text().splitlines()]
    assert [w for w, _ in lines] == ["start", "end", "start", "end"]
    assert lines[0][1] == lines[1][1] != lines[2][1] == lines[3][1]
    assert (tmp_path / "_build" / ".lock").exists()
