"""The port's L0 near-cache (``l0_entries > 0``) against the JAX package,
on the CPU.

``tests/test_l0.py``'s mixed trace (zipf keys, 30% SETs, each write's
payload a unique stamp) runs step by step through ``repro.core.cache``
and ``repro_torch.core.cache`` from the same config, on both backends,
with a multi-tenant L0 config too; then through both ``execute()``s,
sequential and as a strict ``GroupPlan``.  Every step's result (hits and
values) and state, the seven L0 client arrays and ``bucket_ver``
included, are compared.  Then the single-pool contracts of
``tests/test_l0.py`` on the port: disabled by default with zero counts,
``l0_entries=0`` bit-identical to absent, no stale reads across
concurrent lanes, reference equal to fused, L0 hits moving no RDMA
counter, and the ``execute()`` surface paying for itself in read bytes.
The in-place step writes only the columns ``written_columns`` names.

Tolerance: integers bit-equal; ``ext`` and ``gds_L`` within 4 ulp, the
expert weights within 16 (they compound every sync's ``exp``).
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
from repro.workloads import plan as j_plan
from repro_torch.core import cache as t_cache
from repro_torch.core import types as t_types
from repro_torch.core.execute import execute as t_execute
from repro_torch.core.execute import make as t_make
from repro_torch.workloads import plan as t_plan

_COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def _t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _mixed_trace(T, C, n_keys, seed, write_frac=0.3):
    """``tests/test_l0.py``'s trace: zipf keys, SETs, and payloads whose
    word 0 is the key and word 1 a unique write stamp."""
    rng = np.random.default_rng(seed)
    keys = rng.zipf(1.2, size=(T, C)).clip(1, n_keys).astype(np.uint32)
    writes = rng.random((T, C)) < write_frac
    stamps = np.arange(T * C, dtype=np.uint32).reshape(T, C)
    vals = np.stack([keys, stamps], axis=-1).astype(np.uint32)
    return keys, writes, vals


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


def _assert_parts(t_parts, j_parts):
    for conv, got, want, what in zip(
            (t_types.state_to_numpy, t_types.clients_to_numpy,
             t_types.stats_to_numpy), t_parts, j_parts,
            ("state", "clients", "stats")):
        _assert_tree(conv(got), want, what)


@pytest.mark.parametrize("backend,tenants", [
    ("reference", 1), ("fused", 1), ("reference", 2), ("fused", 2)])
def test_steps_match_jax(backend, tenants):
    """Step by step on the mixed trace over a pool it overruns: every
    step's hits, values, state (``bucket_ver`` included), client arrays
    (the seven L0 arrays included) and stats equal the JAX step's; with
    two tenants, their budgets and the tenant column too."""
    T, C = 90, 4
    keys, writes, vals = _mixed_trace(T, C, 300, seed=2, write_frac=0.35)
    ten = np.tile(np.arange(C) % tenants, (T, 1)).astype(np.uint32)
    kw = dict(n_buckets=32, assoc=4, capacity=64, l0_entries=6,
              sync_period=4, n_tenants=tenants, backend=backend)
    cfg_j, cfg_t = j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)
    jstep = jax.jit(lambda s, c, a, k, w, v, tn: j_cache.access_group(
        cfg_j, s, c, a, k, is_write=w, values=v, tenant=tn))
    j = j_cache.make_cache(cfg_j, C, 0)
    t = t_cache.make_cache(cfg_t, C, 0, "cpu")
    for r in range(T):
        *j, jres = jstep(*j, jnp.asarray(keys[r][None]),
                         jnp.asarray(writes[r][None]),
                         jnp.asarray(vals[r][None]), jnp.asarray(ten[r][None]))
        *t, tres = t_cache.access_group(
            cfg_t, *t, _t64(keys[r][None]),
            is_write=torch.from_numpy(writes[r][None]),
            values=_t64(vals[r][None]), tenant=_t64(ten[r][None]))
        hit = np.asarray(jres.hit)
        assert np.array_equal(tres.hit.numpy(), hit), r
        assert np.array_equal(tres.value.numpy()[hit],
                              np.asarray(jres.value)[hit]), r
        _assert_parts(t, j)
    st = t[2]
    assert int(st.l0_hits) > 0 and int(st.l0_invalidations) > 0
    assert int(st.evictions) > 0


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("plan", [None, "strict8"])
def test_execute_matches_jax(plan, backend):
    """The L0 tier through both ``execute()``s: sequential and a strict
    plan of width 8 (several rounds of one lane in a step: the fill takes
    the lane's last fillable request)."""
    keys, writes, _ = _mixed_trace(160, 8, 400, seed=3)
    kw = dict(n_buckets=64, assoc=4, capacity=96, l0_entries=8,
              sync_period=4, backend=backend)
    cfg_j, cfg_t = j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)
    jp = tp = None
    if plan == "strict8":
        jp = j_plan.plan_groups(keys, 64, 8, scope="strict", is_write=writes)
        tp = t_plan.plan_groups(keys, 64, 8, scope="strict", is_write=writes)
    jr = j_execute(j_make(cfg_j, 8, 0), keys, plan=jp, is_write=writes)
    tr = t_execute(t_make(cfg_t, 8, 0, device="cpu"), keys, plan=tp,
                   is_write=writes)
    assert np.array_equal(tr.hits, np.asarray(jr.hits))
    _assert_parts((tr.state, tr.clients, tr.stats),
                  (jr.state, jr.clients, jr.stats))
    assert int(tr.stats.l0_hits) > 0 and int(tr.stats.l0_invalidations) > 0
    assert int(tr.stats.evictions) > 0


def _run_steps(cfg, keys, writes, vals):
    """``tests/test_l0.py``'s oracle, step by step through the port: a
    hit on a key some earlier step wrote serves that write's stamp (no
    stale read, read-your-writes); a step's SET hits commit in lane order
    (the last wins), its misses through the first inserting lane."""
    st, cl, sa = t_cache.make_cache(cfg, keys.shape[1], 0, "cpu")
    committed = {}
    T, C = keys.shape
    for t in range(T):
        st, cl, sa, res = t_cache.access_group_(
            cfg, st, cl, sa, _t64(keys[t][None]),
            is_write=torch.from_numpy(writes[t][None]),
            values=_t64(vals[t][None]))
        hit, val = res.hit[0].numpy(), res.value[0].numpy()
        for c in range(C):
            k = int(keys[t, c])
            if hit[c] and not writes[t, c] and k in committed:
                assert int(val[c, 0]) == k, (t, c)
                assert int(val[c, 1]) == committed[k], (t, c, k)
        first = set()
        for c in range(C):
            k = int(keys[t, c])
            if hit[c]:
                if writes[t, c]:
                    committed[k] = int(vals[t, c, 1])
            elif k not in first:
                first.add(k)
                committed[k] = int(vals[t, c, 1])
    return st, cl, sa


def test_l0_disabled_is_default_and_counts_zero():
    cfg = t_types.CacheConfig(n_buckets=128, assoc=4, capacity=128)
    assert cfg.l0_entries == 0
    _, cl, sa = _run_steps(cfg, *_mixed_trace(40, 4, 300, seed=0))
    assert int(sa.l0_hits) == 0 and int(sa.l0_invalidations) == 0
    assert cl.l0_key.shape == (4, 0)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_l0_zero_bit_identical_to_absent(backend):
    base = t_types.CacheConfig(n_buckets=128, assoc=4, capacity=128,
                               backend=backend)
    explicit = t_types.CacheConfig(n_buckets=128, assoc=4, capacity=128,
                                   backend=backend, l0_entries=0)
    assert hash(base) == hash(explicit) and base == explicit
    assert t_cache.written_columns(base) == t_cache.WRITTEN
    trace = _mixed_trace(30, 4, 200, seed=1)
    for a, b in zip(_run_steps(base, *trace), _run_steps(explicit, *trace)):
        for f, u, v in zip(a._fields, a, b):
            assert torch.equal(u, v), f


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_l0_no_stale_reads_concurrent_lanes(backend):
    """Every hit, L0 or remote, serves the last committed write."""
    cfg = t_types.CacheConfig(n_buckets=128, assoc=4, capacity=128,
                              backend=backend, l0_entries=6)
    _, _, sa = _run_steps(cfg, *_mixed_trace(80, 4, 60, seed=2,
                                             write_frac=0.35))
    assert int(sa.l0_hits) > 0 and int(sa.l0_invalidations) > 0


def test_l0_reference_fused_decision_equal():
    """The L0 probe and fill are shared torch code: the two backends end
    bit-equal in state, clients and stats."""
    trace = _mixed_trace(40, 4, 100, seed=3)
    a, b = (_run_steps(t_types.CacheConfig(
        n_buckets=128, assoc=4, capacity=128, backend=be, l0_entries=6),
        *trace) for be in ("reference", "fused"))
    for x, y in zip(a, b):
        for f, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), f
    assert int(a[2].l0_hits) > 0


def test_l0_hits_cost_zero_rdma():
    """An L0 hit adds to gets, hits and hit_bytes and to no RDMA op or
    byte counter."""
    cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=64,
                              l0_entries=4)
    st, cl, sa = t_cache.make_cache(cfg, 4, 0, "cpu")
    row = _t64([[1, 2, 3, 4]])
    st, cl, sa, _ = t_cache.access_group(cfg, st, cl, sa, row,
                                         is_write=torch.ones((1, 4),
                                                             dtype=torch.bool))
    st, cl, sa, _ = t_cache.access_group(cfg, st, cl, sa, row)
    wire = ("rdma_read", "rdma_write", "rdma_cas", "rdma_faa",
            "rdma_read_bytes", "rdma_write_bytes")
    base = {f: int(getattr(sa, f)) for f in wire}
    for _ in range(5):
        st, cl, sa, res = t_cache.access_group(cfg, st, cl, sa, row)
        assert bool(res.hit.all())
    for f, v in base.items():
        assert int(getattr(sa, f)) == v, f
    assert int(sa.l0_hits) == 20
    assert int(sa.gets) == 24 and int(sa.hits) == 24


def test_l0_through_execute_api():
    """The tier through ``execute()`` pays for itself in read bytes on a
    zipfian read trace, within 1 pp of the hit ratio without it."""
    trace = np.random.default_rng(3).zipf(1.5, size=4096).clip(
        1, 500).astype(np.uint32).reshape(512, 8)
    runs = [t_execute(t_make(t_types.CacheConfig(
        n_buckets=256, assoc=4, capacity=256, l0_entries=n), 8,
        device="cpu"), trace) for n in (0, 8)]
    base, l0 = (r.stats for r in runs)
    assert int(base.l0_hits) == 0 and int(l0.l0_hits) > 0
    assert int(l0.rdma_read_bytes) < int(base.rdma_read_bytes)
    hr = [int(s.hits) / int(s.gets) for s in (base, l0)]
    assert abs(hr[0] - hr[1]) < 0.01


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_in_place_step_writes_its_written_columns(backend):
    """On a multi-tenant L0 config the functional step leaves the
    caller's state as it was, the in-place step returns the very tensors
    of ``written_columns`` (``tenant`` and ``bucket_ver`` among them)
    and the two agree bit for bit."""
    kw = dict(n_buckets=16, assoc=4, capacity=32, l0_entries=4, n_tenants=2,
              backend=backend)
    cfg = t_types.CacheConfig(**kw)
    cols = t_cache.written_columns(cfg)
    assert cols == t_cache.WRITTEN + ("tenant", "bucket_ver")
    keys, writes, vals = _mixed_trace(40, 4, 2000, seed=5)
    ten = np.tile([0, 1, 0, 1], (40, 1))
    func = t_cache.make_cache(cfg, 4, 0, "cpu")
    inplace = t_cache.make_cache(cfg, 4, 0, "cpu")
    for r in range(40):
        kw = dict(is_write=torch.from_numpy(writes[r][None]),
                  values=_t64(vals[r][None]), tenant=_t64(ten[r][None]))
        old = func[0]
        before = [t.clone() for t in old]
        *func, _ = t_cache.access_group(cfg, *func, _t64(keys[r][None]), **kw)
        assert all(torch.equal(a, b) for a, b in zip(before, old))
        held = [getattr(inplace[0], f) for f in cols]
        *inplace, _ = t_cache.access_group_(cfg, *inplace,
                                            _t64(keys[r][None]), **kw)
        assert all(getattr(inplace[0], f) is c for f, c in zip(cols, held))
        for x, y in zip(func, inplace):
            for f, u, v in zip(x._fields, x, y):
                assert torch.equal(u, v), (r, f)
    assert int(inplace[2].l0_hits) > 0 and int(inplace[2].evictions) > 0
    assert int(inplace[0].bucket_ver.sum()) > 0
