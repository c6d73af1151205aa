"""The port's three main-path kernels against the JAX package's Pallas
kernels, on the CPU.

Each plain version in ``repro_torch/kernels/ref.py`` (what the op
wrappers run for CPU tensors) is held against the Pallas kernel it
stands for, run in interpret mode as ``tests/test_kernels.py`` runs it:
duplicates, -1 no-ops, odd batch sizes, history ages that wrap mod
2^32, per-op quotas above one block, tenant filters and W = 128.
Integer outputs are bit-equal; the f32 ``ext`` column is held to
``assert_array_max_ulp(maxulp=4)`` (XLA and PyTorch round ``exp`` apart).

The CUDA kernels themselves build and run only on the card:
``tests/test_torch_cuda.py`` compares them with the plain versions there.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import hash_key as j_hash_key
from repro.kernels import ops as jops
from repro_torch.kernels import ops, runtime
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
    (4, 11, 5, 11, 3, ("lfu",), False)])
def test_ranked_eviction_matches_pallas(seed, C, B, W, K, experts, filt):
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
    quota = rng.integers(0, 5, B).astype(np.int32)
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


# ---------------------------------------------------------------------------
# the op wrappers
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launches()
    ops.hit_metadata_update_op(_t([0, 0]), _t([0, 0]), torch.zeros(2, 4),
                               _t([1]), _t([3]), _t([-1]), _t([0]))
    q = torch.zeros(1, 3, 2, 32)
    ops.flash_attention_op(q, q, q)
    assert ops.launches() == {"access_probe": 0, "hit_metadata_update": 0,
                              "ranked_eviction": 0, "flash_attention": 0}


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


def test_each_cuda_source_carries_its_note_and_entry_point():
    srcs = {p.stem: p.read_text() for p in runtime.sources()}
    assert set(srcs) == {"access_probe", "hit_metadata_update",
                         "ranked_eviction", "flash_attention"}
    for name, text in srcs.items():
        assert f"extern \"C\" int {name}_launch(" in text
        assert "Replaces the Pallas kernel" in text
        assert "Bound on the H100" in text
        assert "cudaGetLastError()" in text
    assert set(runtime.SIGNATURES) == {f"{n}_launch" for n in srcs}
    assert "--use_fast_math" not in runtime.FLAGS
    assert re.search(r"compute_90a,code=sm_90a", " ".join(runtime.ARCH))
    assert Path(runtime.BUILD_DIR).name == "_build"
