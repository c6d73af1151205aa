"""The port on the card: the CUDA kernels against their plain versions,
and whole traces on the card against the same traces on the CPU.

Every test here needs a CUDA device; the ``cuda`` fixture skips it
elsewhere.  Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The file imports no JAX (the card's machine has none, and
``--noconftest`` keeps ``tests/conftest.py`` from importing it): the
CPU run of the port, which ``tests/test_torch_cache.py`` holds against
the JAX package, is the reference here.  Integers are bit-equal; f32
columns within 16 ulp of the CPU run (see ``_same``), and a kernel's
``ext`` output within 2 ulp of its plain version on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import CacheConfig, execute, make
from repro_torch.core import types as t_types
from repro_torch.core.hashing import hash_key
from repro_torch.kernels import ops, ref
from repro_torch.workloads import gen, plan

EXPERTS = ("lru", "lfu", "fifo", "size", "hyperbolic")
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
    assert ops.launches() == {"access_probe": 1, "hit_metadata_update": 1,
                              "ranked_eviction": 2}


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
    assert launches == {k: want for k in launches}


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
    assert first == {k: keys.shape[0] + 1 for k in first}
    assert ops.launches() == {k: short for k in first}
    assert [w["compiled"] for w in r1.windows + r2.windows] == [True, False]
    assert np.array_equal(r2.hits, r1.hits[:short])
