"""The port's multi-tenant cache (``n_tenants > 1``) against the JAX
package, on the CPU.

Seeded two-tenant and three-tenant traces (the latter a ``tenant_mix``
with a flash crowd of objects up to 8 blocks) run through
``repro.core.execute`` and ``repro_torch.core.execute`` from the same
config and seed, sequentially and as a strict ``GroupPlan`` of width 8,
under both backends; then from a JAX-warmed multi-tenant state carried
across with ``state_from_numpy``.  The JAX fused backend runs its Pallas
kernels in interpret mode.  Then the single-pool contracts of
``tests/test_tenants.py``, on the port: single-tenant shapes and tenant
ids ignored, backends bit-equal, budgets never exceeded under a flash
crowd (checked on every step, where the port's ``tenant_bytes``, moved
by the written slots' change, must also equal the JAX step's recompute
from the whole table), growing SETs refused at the budget, overcommitted
budgets sharing the pool, per-tenant weights converging independently,
grouped equal to sequential, and ``split_tenant_budgets``.  The port's
copies of the workload generators give the JAX package's arrays.

Tolerance: integer state, ``OpStats``, the FC-cache columns and the
per-round hits are bit-equal; ``ext`` and ``gds_L`` within 4 ulp, the
[T, E] expert weights (which compound every sync's ``exp``) within 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as j_cache
from repro.core import types as j_types
from repro.core.execute import execute as j_execute
from repro.core.execute import make as j_make
from repro.workloads import gen as j_gen
from repro.workloads import plan as j_plan
from repro_torch.core import cache as t_cache
from repro_torch.core import types as t_types
from repro_torch.core.execute import execute as t_execute
from repro_torch.core.execute import make as t_make
from repro_torch.workloads import gen as t_gen
from repro_torch.workloads import plan as t_plan

# f32 columns that compound the exp rounding of every weight sync.
_COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _cfgs(**kw):
    kw = dict(experts=("lru", "lfu"), **kw)
    return j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)


def _two_tenant_trace(T=150, C=8, n_keys=2000, theta=0.7, seeds=(1, 2)):
    """``tests/test_tenants.py``'s trace: lanes [:C//2] tenant 0, the
    rest tenant 1, disjoint key spaces."""
    h = C // 2
    k0 = j_gen.zipfian(T * h, n_keys, theta=theta, seed=seeds[0])
    k1 = (j_gen.zipfian(T * h, n_keys, theta=theta, seed=seeds[1])
          + np.uint32(1 << 20))
    keys = np.zeros((T, C), np.uint32)
    keys[:, :h] = k0.reshape(T, h)
    keys[:, h:] = k1.reshape(T, h)
    ten = np.zeros((T, C), np.uint32)
    ten[:, h:] = 1
    return keys, ten


FLASH_SPECS = (dict(kind="zipf", n_keys=1_000, theta=0.9, lanes=4),
               dict(kind="scan", hot_keys=800, scan_len=300, lanes=2),
               dict(kind="flash", hot_keys=2_000, max_blocks=8, lanes=6))


def _assert_tree(got: dict, want, what: str):
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = got[f]
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_array_max_ulp(
                g, w, maxulp=16 if f in _COMPOUNDED else 4)
        else:
            assert np.array_equal(g, w.astype(g.dtype)), (what, f)


def _assert_same(t_res, j_res):
    assert np.array_equal(t_res.hits, np.asarray(j_res.hits))
    assert np.array_equal(t_res.ops, np.asarray(j_res.ops))
    np.testing.assert_array_max_ulp(t_res.weights, np.asarray(j_res.weights),
                                    maxulp=16)
    _assert_tree(t_types.state_to_numpy(t_res.state), j_res.state, "state")
    _assert_tree(t_types.clients_to_numpy(t_res.clients), j_res.clients,
                 "clients")
    _assert_tree(t_types.stats_to_numpy(t_res.stats), j_res.stats, "stats")


def _plans(keys, n_buckets, ten, sizes=None):
    jp = j_plan.plan_groups(keys, n_buckets, 8, scope="strict", sizes=sizes,
                            tenants=ten)
    tp = t_plan.plan_groups(keys, n_buckets, 8, scope="strict", sizes=sizes,
                            tenants=ten)
    for f in ("keys", "is_write", "sizes", "tenants", "src_t"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    return jp, tp


def _both(cfg_j, cfg_t, keys, ten, sizes=None, plan=None, seed=0):
    jp = tp = None
    if plan == "strict8":
        jp, tp = _plans(keys, cfg_j.n_buckets, ten, sizes)
    C = keys.shape[1]
    jr = j_execute(j_make(cfg_j, C, seed), keys, plan=jp, sizes=sizes,
                   tenants=ten)
    tr = t_execute(t_make(cfg_t, C, seed, device="cpu"), keys, plan=tp,
                   sizes=sizes, tenants=ten)
    _assert_same(tr, jr)
    return tr


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("plan", [None, "strict8"])
def test_two_tenant_trace_matches_jax(plan, backend):
    """``test_multi_tenant_backends_bit_equal``'s eviction-heavy config
    (asymmetric budgets 96 / 48): the port equals the JAX package."""
    keys, ten = _two_tenant_trace()
    cfg_j, cfg_t = _cfgs(n_buckets=128, assoc=8, capacity=256, n_tenants=2,
                         tenant_budget_blocks=(96, 48), sync_period=20,
                         backend=backend)
    tr = _both(cfg_j, cfg_t, keys, ten, plan=plan, seed=3)
    assert int(tr.stats.evictions) > 0 and int(tr.stats.weight_syncs) > 0
    assert tr.weights.shape == (tr.hits.shape[0], 2, 2)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("plan", [None, "strict8"])
def test_sized_tenant_mix_matches_jax(plan, backend):
    """Three tenants of ``tenant_mix`` (a steady zipf service, a scan
    tenant and a flash crowd of objects up to 8 blocks) on a pool the
    crowd overruns: scoped evictions, the budget gate's refusals and the
    per-tenant weights all equal the JAX package's."""
    keys, ten, sizes = t_gen.tenant_mix(12 * 240, 12, FLASH_SPECS, seed=5)
    cfg_j, cfg_t = _cfgs(n_buckets=96, assoc=8, capacity=384, n_tenants=3,
                         sample_window=64, sync_period=10, backend=backend)
    tr = _both(cfg_j, cfg_t, keys, ten, sizes, plan=plan)
    assert int(tr.stats.evictions) > 0 and int(tr.stats.insert_drops) > 0
    assert int(tr.stats.weight_syncs) > 0


def test_warm_multi_tenant_state_carried_across_from_jax():
    """Both packages continue from one JAX-warmed multi-tenant table
    (tenant column, [T, E] weights, per-tenant regret counters): the
    carried state makes the same decisions as the JAX state."""
    keys, ten, sizes = t_gen.tenant_mix(12 * 200, 12, FLASH_SPECS, seed=8)
    cfg_j, cfg_t = _cfgs(n_buckets=96, assoc=8, capacity=384, n_tenants=3,
                         sample_window=64, sync_period=10, backend="fused")
    half = keys.shape[0] // 2
    warm = j_execute(j_make(cfg_j, 12, 1), keys[:half], plan=None,
                     sizes=sizes[:half], tenants=ten[:half])
    jp, tp = _plans(keys[half:], cfg_j.n_buckets, ten[half:], sizes[half:])
    jr = j_execute(warm.cache, keys[half:], plan=jp, sizes=sizes[half:],
                   tenants=ten[half:])
    tc = t_make(cfg_t, 12, 1, device="cpu")._replace(
        state=t_types.state_from_numpy(warm.state, "cpu"),
        clients=t_types.clients_from_numpy(warm.clients, "cpu"),
        stats=t_types.stats_from_numpy(warm.stats, "cpu"))
    tr = t_execute(tc, keys[half:], plan=tp, sizes=sizes[half:],
                   tenants=ten[half:])
    _assert_same(tr, jr)
    assert int(tr.stats.evictions) > int(warm.stats.evictions) > 0


def test_single_tenant_shapes_unchanged():
    """n_tenants=1 keeps the classic [E] / [C, E] layouts; [T, E] and
    [C, T, E] otherwise, as in the JAX package."""
    _, cfg = _cfgs(n_buckets=64, assoc=8, capacity=128)
    st, cl, _ = t_cache.make_cache(cfg, 4, 0, "cpu")
    assert st.weights.shape == (2,)
    assert cl.local_weights.shape == (4, 2)
    assert cl.penalty_cnt.shape == (4,)
    assert st.tenant_bytes.shape == (1,)
    _, cfg2 = _cfgs(n_buckets=64, assoc=8, capacity=128, n_tenants=3)
    st2, cl2, _ = t_cache.make_cache(cfg2, 4, 0, "cpu")
    assert st2.weights.shape == (3, 2)
    assert cl2.local_weights.shape == (4, 3, 2)
    assert cl2.penalty_cnt.shape == (4, 3)
    keys, ten = _two_tenant_trace(T=8)
    r = t_execute(t_make(cfg, 8, 0, device="cpu"), keys, plan=None,
                  tenants=ten)
    assert r.weights.shape == (8, 2)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_single_tenant_ignores_tenant_ids(backend):
    """With n_tenants=1 a tenant array changes nothing, bit for bit."""
    keys, ten = _two_tenant_trace(T=60)
    _, cfg = _cfgs(n_buckets=128, assoc=8, capacity=256, sync_period=20,
                   backend=backend)
    a = t_execute(t_make(cfg, 8, 3, device="cpu"), keys, plan=None)
    b = t_execute(t_make(cfg, 8, 3, device="cpu"), keys, plan=None,
                  tenants=ten)
    assert np.array_equal(a.hits, b.hits)
    for x, y in ((a.state, b.state), (a.clients, b.clients),
                 (a.stats, b.stats)):
        for f, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), f


def test_tenant_ids_past_the_last_count_as_the_last():
    """A request's tenant id is clamped to n_tenants - 1, as the JAX step
    clamps it: ids 1 and 7 run the same two-tenant trace alike."""
    keys, ten = _two_tenant_trace(T=40)
    _, cfg = _cfgs(n_buckets=64, assoc=8, capacity=128, n_tenants=2,
                   tenant_budget_blocks=(80, 48))
    a, b = (t_execute(t_make(cfg, 8, 3, device="cpu"), keys, plan=None,
                      tenants=t) for t in (ten, ten * 7))
    assert np.array_equal(a.hits, b.hits)
    for f, u, v in zip(a.state._fields, a.state, b.state):
        assert torch.equal(u, v), f
    assert int(a.stats.evictions) > 0 and int(a.state.tenant.max()) == 1


def test_multi_tenant_backends_bit_equal():
    """The port's reference and fused backends agree bit for bit on
    state, stats and the weight trajectory of a two-tenant trace."""
    keys, ten = _two_tenant_trace()
    base = dict(n_buckets=128, assoc=8, capacity=256, n_tenants=2,
                tenant_budget_blocks=(96, 48), experts=("lru", "lfu"),
                sync_period=20)
    a, b = (t_execute(t_make(t_types.CacheConfig(backend=be, **base), 8, 3,
                             device="cpu"), keys, plan=None, tenants=ten)
            for be in ("reference", "fused"))
    assert np.array_equal(a.hits, b.hits)
    assert np.array_equal(a.weights, b.weights)
    for x, y in ((a.state, b.state), (a.clients, b.clients),
                 (a.stats, b.stats)):
        for f, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), f
    assert int(a.stats.evictions) > 0
    assert a.state.weights.shape == (2, 2)


def _live_bytes(st, Tn) -> list:
    size, ten = st.size.numpy(), st.tenant.numpy()
    live = (size != 0) & (size != 255)
    return [int(size[live & (ten == t)].sum()) for t in range(Tn)]


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_budgets_never_exceeded_under_flash_crowd(backend):
    """Per-step per-tenant occupancy <= budget through a flash-crowd
    stampede of objects up to 8 blocks, step by step in both packages:
    the port's ``tenant_bytes`` (moved by the change at the slots a step
    writes) equals the JAX step's recompute from the whole table, and
    the live sizes of the port's own table, at every step."""
    keys, ten, sizes = t_gen.tenant_mix(12 * 200, 12, FLASH_SPECS, seed=5)
    cfg_j, cfg_t = _cfgs(n_buckets=384, assoc=8, capacity=768, n_tenants=3,
                         sample_window=128, backend=backend)
    jstep = jax.jit(lambda s, c, a, k, tn, sz: j_cache.access(
        cfg_j, s, c, a, k, tenant=tn, obj_size=sz))
    j = j_cache.make_cache(cfg_j, 12, 0)
    t = t_cache.make_cache(cfg_t, 12, 0, "cpu")
    budget = np.asarray(cfg_t.tenant_budgets)
    peak = np.zeros(3, np.int64)
    for r in range(keys.shape[0]):
        *j, _ = jstep(*j, jnp.asarray(keys[r]), jnp.asarray(ten[r]),
                      jnp.asarray(sizes[r]))
        *t, _ = t_cache.access_group_(cfg_t, *t, _t64(keys[r][None]),
                                      tenant=_t64(ten[r][None]),
                                      obj_size=_t64(sizes[r][None]))
        occ = t[0].tenant_bytes.numpy()
        assert np.array_equal(occ, np.asarray(j[0].tenant_bytes)), r
        assert (occ <= budget).all(), (r, occ, budget)
        assert occ.tolist() == _live_bytes(t[0], 3), r
        peak = np.maximum(peak, occ)
    assert int(t[2].evictions) > 0
    assert peak[2] >= 0.9 * budget[2], (peak, budget)   # the crowd filled it
    _assert_tree(t_types.state_to_numpy(t[0]), j[0], "state")
    _assert_tree(t_types.stats_to_numpy(t[2]), j[2], "stats")


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_growing_sets_cannot_break_the_budget(backend):
    """SET re-sizes pass the same gate as inserts: a tenant at its budget
    cannot grow its objects (the refused grow keeps the old size and
    payload), and shrinking SETs free room in the same step."""
    C = 4
    _, cfg = _cfgs(n_buckets=64, assoc=8, capacity=64, n_tenants=2,
                   tenant_budget_blocks=(32, 32), value_words=2,
                   backend=backend)
    st, cl, sa = t_cache.make_cache(cfg, C, 0, "cpu")
    keys = torch.arange(1, C + 1)
    ten = torch.zeros(C, dtype=torch.int64)
    w1 = torch.ones(C, dtype=torch.bool)
    v1 = torch.stack([keys, keys], dim=1)
    v2 = torch.stack([keys * 7, keys * 9], dim=1)

    def step(st, cl, sa, k, size, v):
        return t_cache.access(cfg, st, cl, sa, k, is_write=w1,
                              obj_size=torch.full((C,), size), tenant=ten,
                              values=v)
    st, cl, sa, _ = step(st, cl, sa, keys, 8, v1)   # 4 x 8 = the budget
    assert int(st.tenant_bytes[0]) == 32
    st, cl, sa, r = step(st, cl, sa, keys, 16, v2)  # every grow refused
    assert bool(r.hit.all())
    assert int(st.tenant_bytes[0]) == 32
    live = (st.size != 0) & (st.size != 255)
    assert bool((st.size[live] == 8).all())
    got = {int(k): st.values[i].tolist()
           for i, k in enumerate(st.key.tolist()) if live[i]}
    for i, k in enumerate(range(1, C + 1)):
        assert got[k] == v1[i].tolist()             # the old payload kept
    st, cl, sa, _ = step(st, cl, sa, keys, 2, v1)   # shrink 8 -> 2
    assert int(st.tenant_bytes[0]) == 8
    st, cl, sa, _ = step(st, cl, sa, keys * torch.tensor([1, 0, 0, 0]), 16,
                         v2)
    assert int(st.tenant_bytes[0]) == 2 * 3 + 16    # one grew to 16
    assert bool((st.tenant_bytes <= st.tenant_budget).all())
    assert int(sa.insert_drops) == C


def test_overcommitted_budgets_share_the_pool():
    """Budgets may overcommit (sum > capacity): tenants then share the
    pool under the global quota."""
    keys, ten = _two_tenant_trace(T=120, theta=0.6)
    _, cfg = _cfgs(n_buckets=64, assoc=8, capacity=128, n_tenants=2,
                   tenant_budget_blocks=(128, 128))
    tr = t_execute(t_make(cfg, 8, 3, device="cpu"), keys, plan=None,
                   tenants=ten)
    assert int(tr.stats.evictions) > 0
    assert bool((tr.state.tenant_bytes <= 128).all())
    assert int(tr.state.bytes_cached) <= 128 + keys.shape[1]


def test_per_tenant_weights_converge_independently():
    """Tenant 0 loops over 4/3 of its budget (regrets penalize lru),
    tenant 1 runs a sliding window (stale frequencies mislead lfu): each
    tenant's weight row moves toward its own best expert, in one pool."""
    T, C, h = 600, 8, 4
    n = T * h
    k0 = (np.arange(n, dtype=np.uint32) % (128 * 4 // 3)) + 1
    k1 = t_gen.lru_friendly(n, window=256, seed=1) + np.uint32(1 << 20)
    keys = np.zeros((T, C), np.uint32)
    keys[:, :h] = k0.reshape(T, h)
    keys[:, h:] = k1.reshape(T, h)
    ten = np.zeros((T, C), np.uint32)
    ten[:, h:] = 1
    _, cfg = _cfgs(n_buckets=256, assoc=8, capacity=256, n_tenants=2,
                   sync_period=10)
    tr = t_execute(t_make(cfg, C, 3, device="cpu"), keys, plan=None,
                   tenants=ten)
    w = tr.state.weights.numpy()                     # [2, 2]: lru, lfu
    assert int(tr.stats.regrets) > 0
    assert w[0, 1] > w[0, 0], w
    assert w[1, 0] > w[1, 1], w


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_grouped_multi_tenant_matches_sequential(backend):
    """A strict bucket-disjoint plan runs exactly as its rounds would in
    sequence, tenant ids threaded through (no evictions)."""
    keys, ten = _two_tenant_trace(T=60, n_keys=400, theta=0.99)
    _, cfg = _cfgs(n_buckets=256, assoc=8, capacity=1024, n_tenants=2,
                   use_fc=False, backend=backend)
    gp = t_plan.plan_groups(keys, cfg.n_buckets, 8, scope="strict",
                            tenants=ten)
    assert gp.tenants is not None
    rk, _, _ = gp.rounds()
    rt = gp.tenants.reshape(-1, keys.shape[1])
    st, cl, _ = t_cache.make_cache(cfg, keys.shape[1], 3, "cpu")
    seq = t_cache._run_trace_impl(cfg, st, cl, _t64(rk), tenant=_t64(rt))
    bat = t_cache._run_trace_grouped_impl(cfg, st, cl, _t64(gp.keys),
                                          tenant=_t64(gp.tenants))
    assert torch.equal(seq.hits, bat.hits)
    for x, y in ((seq.state, bat.state), (seq.stats, bat.stats)):
        for f, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), f


def test_split_tenant_budgets_conserves_totals():
    """Per-shard shares sum exactly to the global budgets, as the JAX
    package splits them."""
    for budgets, n_shards in (((2, 7, 100), 4), ((1, 1), 8), ((97,), 3)):
        m = t_types.split_tenant_budgets(budgets, n_shards)
        assert m.dtype == np.int32 and m.shape == (n_shards, len(budgets))
        np.testing.assert_array_equal(m.sum(axis=0), list(budgets))
        assert (m >= 0).all()
        assert np.array_equal(m, j_types.split_tenant_budgets(budgets,
                                                              n_shards))


_GENERATORS = {
    "lru_friendly": lambda g: g.lru_friendly(3000, n_keys=500, window=64,
                                             seed=4),
    "scan_polluted_zipf": lambda g: g.scan_polluted_zipf(
        5000, hot_keys=300, scan_len=200, seed=6),
    "flash_crowd": lambda g: g.flash_crowd(4000, hot_keys=200,
                                           start_frac=0.3, stop_frac=0.8,
                                           seed=7),
    "shifting_zipf": lambda g: g.shifting_zipf(3001, n_keys=500, n_phases=3,
                                               seed=8),
    "tenant_mix": lambda g: g.tenant_mix(
        16 * 300, 16, FLASH_SPECS + (dict(kind="shift", lanes=4),), seed=9,
        key_stride=1 << 23),
    "object_sizes": lambda g: g.object_sizes(
        np.arange(1, 5000, dtype=np.uint32), max_blocks=8, seed=3),
    "sized_zipfian_zipf": lambda g: g.sized_zipfian(4000, 700, seed=2),
    "sized_zipfian_uniform": lambda g: g.sized_zipfian(
        4000, 700, seed=2, size_dist="uniform", max_blocks=16),
}


@pytest.mark.parametrize("name", sorted(_GENERATORS))
def test_generators_match_jax(name):
    got, want = (_GENERATORS[name](g) for g in (t_gen, j_gen))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t_gen.lfu_friendly is t_gen.scan_polluted_zipf
    with pytest.raises(ValueError, match="tenant kind"):
        t_gen.tenant_mix(64, 4, ("zipf", "nope"))
    with pytest.raises(ValueError, match="lane counts"):
        t_gen.tenant_mix(64, 4, (dict(kind="zipf", lanes=3),))


@pytest.mark.parametrize("plan", [None, "lane4"])
def test_execute_by_lane_counts_each_lanes_hits(plan):
    """``execute(..., by_lane=True)`` (the port's own option) gives each
    round's hits and ops per lane, so a tenant's hit ratio is the sum over
    its lanes; summed over the lanes they are the per-round counts, and
    the run is the same."""
    keys, ten = _two_tenant_trace(T=60)
    _, cfg = _cfgs(n_buckets=128, assoc=8, capacity=256, n_tenants=2)
    gp = (None if plan is None
          else t_plan.pack_rows(keys, cfg.n_buckets, 4, tenants=ten))
    a, b = (t_execute(t_make(cfg, 8, 3, device="cpu"), keys, plan=gp,
                      tenants=ten, by_lane=by) for by in (False, True))
    assert b.hits.shape == b.ops.shape == (a.hits.shape[0], 8)
    assert np.array_equal(b.hits.sum(axis=1), a.hits)
    assert np.array_equal(b.ops.sum(axis=1), a.ops)
    assert np.array_equal(a.weights, b.weights)
    for f, u, v in zip(a.state._fields, a.state, b.state):
        assert torch.equal(u, v), f
    hr = [b.hits[:, t * 4:(t + 1) * 4].sum() / b.ops[:, t * 4:(t + 1) * 4].sum()
          for t in range(2)]
    assert all(0.0 < h < 1.0 for h in hr)
    empty = t_execute(t_make(cfg, 8, 3, device="cpu"), keys[:0], plan=None,
                      by_lane=True)
    assert empty.hits.shape == (0, 8)
