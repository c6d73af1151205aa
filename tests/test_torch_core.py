"""The port's core modules against the JAX package, on the CPU.

Same numpy-seeded inputs through ``repro.core.*`` and its counterpart in
``repro_torch.core``: hashing, the 12 expert priorities, the extension
metadata update, the frequency-counter cache (G=1 and grouped), the
configs and the state carried across with ``state_from_numpy``.

Tolerance: integer outputs are bit-equal.  f32 outputs of elementwise
arithmetic are bit-equal too; those that go through ``exp2`` (LRFU)
may differ by the last place between XLA's and PyTorch's CPU kernels
and are held to ``assert_array_max_ulp(maxulp=4)``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fc_cache as j_fc
from repro.core import hashing as j_hash
from repro.core import priority as j_prio
from repro.core import types as j_types
from repro_torch.core import fc_cache as t_fc
from repro_torch.core import hashing as t_hash
from repro_torch.core import priority as t_prio
from repro_torch.core import types as t_types

EDGE_KEYS = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                      0x61C88647, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def test_splitmix32_edge_and_random_keys():
    rng = np.random.default_rng(0)
    keys = np.concatenate([EDGE_KEYS, rng.integers(0, 2**32, 512,
                                                   dtype=np.uint64)
                           .astype(np.uint32)])
    want = np.asarray(j_hash.splitmix32(jnp.asarray(keys)))
    got = t_hash.splitmix32(_i64(keys))
    assert got.dtype == torch.int64
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(t_hash.hash_key(_i64(keys))), want)


@pytest.mark.parametrize("n_buckets", [1, 7, 64, 100, 262_144])
def test_bucket_of(n_buckets):
    kh = np.asarray(j_hash.hash_key(jnp.asarray(EDGE_KEYS)))
    want = np.asarray(j_hash.bucket_of(jnp.asarray(kh), n_buckets))
    got = t_hash.bucket_of(_i64(kh), n_buckets)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# priorities and extension metadata
# ---------------------------------------------------------------------------

def _mdviews(seed=0, shape=(37, 5)):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    cols = dict(size=np.floor(f(1, 9)), insert_ts=np.floor(f(0, 5000)),
                last_ts=np.floor(f(0, 5000)), freq=np.floor(f(0, 40)),
                ext=rng.uniform(0, 5000, shape + (4,)).astype(np.float32),
                clock=np.float32(5003.0), gds_L=np.float32(1.75))
    cols["cost"] = np.ones(shape, np.float32)
    jv = j_types.MDView(**{k: jnp.asarray(v) for k, v in cols.items()})
    tv = t_types.MDView(**{k: torch.tensor(v) for k, v in cols.items()})
    return jv, tv


@pytest.mark.parametrize("name", sorted(j_prio.REGISTRY))
def test_expert_priority(name):
    jv, tv = _mdviews()
    want = np.asarray(j_prio.REGISTRY[name].priority(jv))
    got = t_prio.REGISTRY[name].priority(tv).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if name == "lrfu":
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
    else:
        assert np.array_equal(got, want)
    assert t_prio.REGISTRY[name].gds_family == j_prio.REGISTRY[name].gds_family


def test_registry_and_stacked_priorities():
    assert tuple(t_prio.REGISTRY) == tuple(j_prio.REGISTRY)
    assert t_prio.ALL_ALGORITHMS == j_prio.ALL_ALGORITHMS
    names = ("lru", "lfu", "fifo", "size", "gds", "hyperbolic")
    jv, tv = _mdviews(seed=1)
    want = np.asarray(j_prio.priorities(jv, names))
    assert np.array_equal(t_prio.priorities(tv, names).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_ext_and_fresh_ext(seed):
    rng = np.random.default_rng(seed)
    n = 257
    ext = rng.uniform(0, 1e4, (n, 4)).astype(np.float32)
    last = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    freq = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    clock = (last.astype(np.uint64) + rng.integers(0, 500, n)).astype(
        np.uint32)
    want = np.asarray(j_prio.update_ext(jnp.asarray(ext), jnp.asarray(last),
                                        jnp.asarray(freq),
                                        jnp.asarray(clock)))
    got = t_prio.update_ext(torch.tensor(ext), _i64(last), _i64(freq),
                            _i64(clock)).numpy()
    assert np.array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_array_max_ulp(got[:, 2], want[:, 2], maxulp=4)
    fj = np.asarray(j_prio.fresh_ext(jnp.asarray(clock), (n,)))
    assert np.array_equal(t_prio.fresh_ext(_i64(clock), (n,)).numpy(), fj)


# ---------------------------------------------------------------------------
# the frequency-counter cache
# ---------------------------------------------------------------------------

def _fc_clients(C, F, seed):
    rng = np.random.default_rng(seed)
    fc_slot = np.where(rng.random((C, F)) < 0.7,
                       rng.integers(0, 40, (C, F)), -1).astype(np.int32)
    fc_delta = np.where(fc_slot >= 0, rng.integers(0, 9, (C, F)),
                        0).astype(np.uint32)
    fc_ins = rng.integers(0, 50, (C, F)).astype(np.uint32)
    cfg_j = j_types.CacheConfig(n_buckets=32, assoc=4, capacity=64,
                                fc_size=F, fc_threshold=10)
    base = j_types.init_clients(cfg_j, C, seed)
    jc = base._replace(fc_slot=jnp.asarray(fc_slot),
                       fc_delta=jnp.asarray(fc_delta),
                       fc_ins=jnp.asarray(fc_ins))
    tc = t_types.clients_from_numpy(jc, "cpu")
    return cfg_j, jc, tc


def _same_clients(tc, jc):
    got = t_types.clients_to_numpy(tc)
    for f in jc._fields:
        assert np.array_equal(got[f], np.asarray(getattr(jc, f))), f


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("use_fc", [True, False])
def test_fc_access(seed, use_fc):
    C, F = 9, 6
    cfg_j, jc, tc = _fc_clients(C, F, seed)
    cfg_j = dataclasses.replace(cfg_j, use_fc=use_fc)
    cfg_t = t_types.CacheConfig(**{f.name: getattr(cfg_j, f.name)
                                   for f in dataclasses.fields(cfg_j)})
    rng = np.random.default_rng(100 + seed)
    slot = np.where(rng.random(C) < 0.8, rng.integers(0, 40, C),
                    -1).astype(np.int32)
    clock = np.uint32(77)
    jc2, jem = j_fc.fc_access(cfg_j, jc, jnp.asarray(slot), jnp.asarray(clock))
    tc2, tem = t_fc.fc_access(cfg_t, tc, _i64(slot), _i64(clock))
    _same_clients(tc2, jc2)
    assert np.array_equal(tem.slot.numpy(), np.asarray(jem.slot))
    assert np.array_equal(tem.delta.numpy(), np.asarray(jem.delta))
    assert int(tem.n_faa) == int(jem.n_faa)
    assert int(tem.n_hit) == int(jem.n_hit)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("G", [2, 8, 11])
def test_fc_access_group(seed, G):
    C, F = 7, 4          # G = 8, 11 > F exercise the overflow spill
    cfg_j, jc, tc = _fc_clients(C, F, seed)
    cfg_t = t_types.CacheConfig(n_buckets=32, assoc=4, capacity=64,
                                fc_size=F, fc_threshold=10)
    rng = np.random.default_rng(200 + seed)
    slots = np.where(rng.random((G, C)) < 0.8, rng.integers(0, 12, (G, C)),
                     -1).astype(np.int32)
    ts = (50 + np.arange(G)).astype(np.uint32)
    jc2, *jout = j_fc.fc_access_group(cfg_j, jc, jnp.asarray(slots),
                                      jnp.asarray(ts))
    tc2, *tout = t_fc.fc_access_group(cfg_t, tc, _i64(slots), _i64(ts))
    _same_clients(tc2, jc2)
    for g, w in zip(tout, jout):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


# ---------------------------------------------------------------------------
# configs and state
# ---------------------------------------------------------------------------

def test_config_defaults_and_validation():
    t = t_types.CacheConfig()
    j = j_types.CacheConfig()
    for f in dataclasses.fields(j):
        if f.name != "backend":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.backend == "fused" and t_types.ExecConfig().backend == "fused"
    for prop in ("n_slots", "history_len", "budget_blocks", "n_experts",
                 "tenant_budgets", "discount"):
        assert getattr(t, prop) == getattr(j, prop), prop
    bad = [dict(n_buckets=4, assoc=2, capacity=8), dict(backend="x"),
           dict(n_tenants=0), dict(l0_entries=-1),
           dict(experts=("lru",) * 33),
           dict(n_tenants=2, tenant_budget_blocks=(1,)),
           dict(n_tenants=2, tenant_budget_blocks=(1, 0))]
    for kw in bad:
        with pytest.raises(ValueError):
            j_types.CacheConfig(**kw)
        with pytest.raises(ValueError):
            t_types.CacheConfig(**kw)
    for kw in (dict(backend="x"), dict(batch=0), dict(plan="wide")):
        with pytest.raises(ValueError):
            t_types.ExecConfig(**kw)


def test_init_state_matches_and_round_trips():
    cfg_j = j_types.CacheConfig(n_buckets=16, assoc=4, capacity=32)
    cfg_t = t_types.CacheConfig(n_buckets=16, assoc=4, capacity=32)
    js, jc, jst = (j_types.init_cache(cfg_j), j_types.init_clients(cfg_j, 5, 3),
                   j_types.init_stats())
    ts = t_types.init_cache(cfg_t, "cpu")
    tc = t_types.init_clients(cfg_t, 5, 3, "cpu")
    tst = t_types.init_stats("cpu")
    for got, want in ((t_types.state_to_numpy(ts), js),
                      (t_types.clients_to_numpy(tc), jc),
                      (t_types.stats_to_numpy(tst), jst)):
        for f in want._fields:
            w = np.asarray(getattr(want, f))
            assert got[f].shape == w.shape, f
            assert np.array_equal(got[f], w), f
    # numpy -> tensors -> numpy is the identity, dtypes restored.
    back = t_types.state_to_numpy(t_types.state_from_numpy(js, "cpu"))
    for f in js._fields:
        assert back[f].dtype == np.asarray(getattr(js, f)).dtype, f
    stats = t_types.stats_add(tst, hits=torch.tensor(3), gets=4)
    assert t_types.hit_ratio(stats) == 0.75
