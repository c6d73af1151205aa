"""The port's cache engine and ``execute()`` against the JAX package, on
the CPU.

Seeded YCSB-A and YCSB-C traces run through ``repro.core.execute`` and
``repro_torch.core.execute`` from the same config and seed, sequentially
(``plan=None``) and as a strict ``GroupPlan`` of width 8, under both
backends; then from a JAX-warmed state carried across with
``state_from_numpy``, and one group of duplicate SETs.  The JAX fused
backend runs its Pallas kernels in interpret mode.

Tolerance: integer state, ``OpStats``, the FC-cache columns and the
per-round hits are bit-equal.  The f32 columns (``weights``,
``local_weights``, ``penalty_acc``, ``ext``, ``gds_L``) are held to
``assert_array_max_ulp(maxulp=4)``: XLA and PyTorch round ``exp`` and
``pow`` apart in the last place.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

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

REPO = Path(__file__).resolve().parents[1]
C = 8
EXPERTS = {"reference": ("lru", "lfu", "gdsf", "lrfu"),
           "fused": ("lru", "lfu", "hyperbolic")}


def _cfgs(backend, **kw):
    kw = dict(n_buckets=64, assoc=4, capacity=96, sync_period=4,
              experts=EXPERTS[backend], backend=backend, **kw)
    return j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)


def _trace(workload, n=1200, seed=3):
    keys, wr = j_gen.ycsb(workload, n, n_keys=400, seed=seed)
    tk, tw = t_gen.ycsb(workload, n, n_keys=400, seed=seed)
    assert np.array_equal(keys, tk) and np.array_equal(wr, tw)
    return j_gen.interleave(keys, C, wr)


# f32 columns that compound the exp/pow rounding of every lazy weight sync
# (XLA and PyTorch differ in the last place a call): held to 16 ulp per
# step, as tests/test_torch_cuda.py holds them; ext and gds_L to 4.
_COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def _assert_tree(got: dict, want, what: str, weight_ulp: int = 4):
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = got[f]
        assert g.shape == w.shape, (what, f)
        if w.dtype.kind == "f":
            try:
                np.testing.assert_array_max_ulp(
                    g, w, maxulp=weight_ulp if f in _COMPOUNDED else 4)
            except AssertionError as e:
                raise AssertionError(f"{what}.{f}: {e}") from None
        else:
            assert np.array_equal(g, w.astype(g.dtype)), (what, f)


def _assert_same(t_res, j_res, weight_ulp: int = 4):
    """``weight_ulp`` bounds the f32 columns that compound every weight
    sync's ``exp`` (``_COMPOUNDED`` and the weight trajectory); ext and
    gds_L are held to 4 ulp."""
    assert np.array_equal(t_res.hits, np.asarray(j_res.hits))
    assert np.array_equal(t_res.ops, np.asarray(j_res.ops))
    np.testing.assert_array_max_ulp(t_res.weights, np.asarray(j_res.weights),
                                    maxulp=weight_ulp)
    for part, conv in (("state", t_types.state_to_numpy),
                       ("clients", t_types.clients_to_numpy),
                       ("stats", t_types.stats_to_numpy)):
        _assert_tree(conv(getattr(t_res, part)), getattr(j_res, part), part,
                     weight_ulp)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("plan", [None, "strict8"])
@pytest.mark.parametrize("workload", ["A", "B", "C", "D"])
def test_execute_matches_jax(workload, plan, backend):
    cfg_j, cfg_t = _cfgs(backend)
    keys, wr = _trace(workload)
    jp = tp = None
    if plan == "strict8":
        jp = j_plan.plan_groups(keys, cfg_j.n_buckets, 8, scope="strict",
                                is_write=wr)
        tp = t_plan.plan_groups(keys, cfg_t.n_buckets, 8, scope="strict",
                                is_write=wr)
        for f in ("keys", "is_write", "sizes", "src_t"):
            assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    jr = j_execute(j_make(cfg_j, C, 0), keys, plan=jp, is_write=wr)
    tr = t_execute(t_make(cfg_t, C, 0, device="cpu"), keys, plan=tp,
                   is_write=wr)
    # YCSB A and C hold the compounded weights within 4 ulp; B and D
    # compound more syncs' exp rounding (D's reference backend drifts 1
    # ulp per few syncs to 5-6), held to the 16 ulp of ROADMAP Queue 3.
    _assert_same(tr, jr, weight_ulp=4 if workload in ("A", "C") else 16)
    assert int(tr.stats.evictions) > 0 and int(tr.stats.weight_syncs) > 0
    assert int(tr.stats.regrets) > 0 and int(tr.stats.fc_flushes) > 0


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_execute_with_a_wide_sample_matches_jax(backend):
    """``n_samples=33`` (a sample wider than one warp's 32 lanes, window
    132) on both backends, sequential and grouped: the same decisions as
    the JAX package, bit for bit in integer state."""
    cfg_j, cfg_t = _cfgs(backend, n_samples=33)
    keys, wr = _trace("A", n=960, seed=4)
    half = keys.shape[0] // 2
    jr = j_execute(j_make(cfg_j, C, 0), keys[:half], plan=None,
                   is_write=wr[:half])
    tr = t_execute(t_make(cfg_t, C, 0, device="cpu"), keys[:half], plan=None,
                   is_write=wr[:half])
    _assert_same(tr, jr)
    jp = j_plan.plan_groups(keys[half:], cfg_j.n_buckets, 8, scope="strict",
                            is_write=wr[half:])
    tp = t_plan.plan_groups(keys[half:], cfg_t.n_buckets, 8, scope="strict",
                            is_write=wr[half:])
    jr2 = j_execute(jr.cache, keys[half:], plan=jp, is_write=wr[half:])
    tr2 = t_execute(tr.cache, keys[half:], plan=tp, is_write=wr[half:])
    _assert_same(tr2, jr2)
    assert int(tr2.stats.evictions) > int(tr.stats.evictions) > 0


def test_warm_state_carried_across_from_jax():
    """Both packages continue from one JAX-warmed table: the carried
    state makes the same decisions as the JAX state it came from."""
    cfg_j, cfg_t = _cfgs("fused")
    keys, wr = _trace("A", n=1600, seed=9)
    half = keys.shape[0] // 2
    warm = j_execute(j_make(cfg_j, C, 1), keys[:half], plan=None,
                     is_write=wr[:half])
    jp = j_plan.plan_groups(keys[half:], cfg_j.n_buckets, 8, scope="strict",
                            is_write=wr[half:])
    jr = j_execute(warm.cache, keys[half:], plan=jp, is_write=wr[half:])
    tc = t_make(cfg_t, C, 1, device="cpu")._replace(
        state=t_types.state_from_numpy(warm.state, "cpu"),
        clients=t_types.clients_from_numpy(warm.clients, "cpu"),
        stats=t_types.stats_from_numpy(warm.stats, "cpu"))
    tp = t_plan.plan_groups(keys[half:], cfg_t.n_buckets, 8, scope="strict",
                            is_write=wr[half:])
    tr = t_execute(tc, keys[half:], plan=tp, is_write=wr[half:])
    _assert_same(tr, jr)
    assert int(tr.stats.evictions) > int(warm.stats.evictions)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_duplicate_sets_in_one_group_are_last_writer_wins(backend):
    """Several lanes and rounds SET the same (present) keys in one group:
    the payload and size the table keeps are the last request's, in both
    packages."""
    cfg_j, cfg_t = _cfgs(backend, value_words=2)
    G = 3
    k0 = np.arange(1, C + 1, dtype=np.uint32)[None, :]
    step = jax.jit(functools.partial(j_cache.access_group, cfg_j))
    js, jc, jst = j_cache.make_cache(cfg_j, C, 0)
    js, jc, jst, _ = step(js, jc, jst, jnp.asarray(k0))
    keys = np.tile(np.array([5, 5, 2, 5, 7, 2, 0, 3], np.uint32), (G, 1))
    wr = np.ones((G, C), bool)
    wr[1, 3] = False
    size = (1 + np.arange(G * C) % 3).reshape(G, C).astype(np.uint32)
    vals = np.arange(G * C * 2, dtype=np.uint32).reshape(G, C, 2) + 100
    js2, jc2, jst2, jres = step(
        js, jc, jst, jnp.asarray(keys), is_write=jnp.asarray(wr),
        obj_size=jnp.asarray(size), values=jnp.asarray(vals))
    ts = t_types.state_from_numpy(js, "cpu")
    tc = t_types.clients_from_numpy(jc, "cpu")
    tst = t_types.stats_from_numpy(jst, "cpu")
    t64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    ts2, tc2, tst2, tres = t_cache.access_group(
        cfg_t, ts, tc, tst, t64(keys), is_write=torch.from_numpy(wr),
        obj_size=t64(size), values=t64(vals))
    assert np.array_equal(tres.hit.numpy(), np.asarray(jres.hit))
    _assert_tree(t_types.state_to_numpy(ts2), js2, "state")
    _assert_tree(t_types.stats_to_numpy(tst2), jst2, "stats")
    # Last writer: key 5's final SET is round 2, lane 3 (lane 3 of round 1
    # is a GET); key 2's is round 2, lane 5.
    got = t_types.state_to_numpy(ts2)
    slot5 = int(np.nonzero(got["key"] == 5)[0][0])
    assert list(got["values"][slot5]) == list(vals[2, 3])
    assert got["size"][slot5] == size[2, 3]


def _snapshot(*parts) -> list:
    return [t_types.state_to_numpy(parts[0]),
            t_types.clients_to_numpy(parts[1]),
            t_types.stats_to_numpy(parts[2])]


def _same_snapshots(x, y) -> bool:
    return all(np.array_equal(a[f], b[f]) for a, b in zip(x, y) for f in a)




@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_in_place_step_matches_functional_step_and_jax(backend):
    """``access_group_`` (in place), ``access_group`` (functional) and
    the JAX step, group by group on one seeded YCSB-A trace of [4, 8]
    groups run past the table's fill: the in-place step returns the very
    column tensors it was given, the functional one leaves its inputs as
    they were, the two agree bit for bit, and both agree with JAX
    (integers bit-equal, ext and gds_L within 4 ulp, the expert weights
    within 16).  Evictions, bucket fallbacks
    and duplicate SETs on one slot within a group all happen."""
    cfg_j, cfg_t = _cfgs(backend, value_words=2)
    G = 4
    keys, wr = _trace("A", n=2048, seed=5)
    NG = keys.shape[0] // G
    keys, wr = keys[:NG * G].reshape(NG, G, C), wr[:NG * G].reshape(NG, G, C)
    rng = np.random.default_rng(5)
    size = rng.integers(1, 4, keys.shape).astype(np.uint32)
    vals = rng.integers(0, 2**32, keys.shape + (2,), dtype=np.uint64
                        ).astype(np.uint32)
    step = jax.jit(functools.partial(j_cache.access_group, cfg_j))
    j = j_cache.make_cache(cfg_j, C, 0)
    inplace = t_cache.make_cache(cfg_t, C, 0, "cpu")
    func = t_cache.make_cache(cfg_t, C, 0, "cpu")
    t64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    dup_sets = 0
    for g in range(NG):
        kw = dict(is_write=wr[g], obj_size=size[g], values=vals[g])
        *j, jres = step(*j, jnp.asarray(keys[g]),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
        tkw = dict(is_write=torch.from_numpy(wr[g]), obj_size=t64(size[g]),
                   values=t64(vals[g]))
        old = func
        before = _snapshot(*old)
        *func, fres = t_cache.access_group(cfg_t, *old, t64(keys[g]), **tkw)
        assert _same_snapshots(before, _snapshot(*old))
        cols = [getattr(inplace[0], f) for f in t_cache.WRITTEN]
        *inplace, ires = t_cache.access_group_(cfg_t, *inplace, t64(keys[g]),
                                               **tkw)
        assert all(getattr(inplace[0], f) is c
                   for f, c in zip(t_cache.WRITTEN, cols))
        assert _same_snapshots(_snapshot(*inplace), _snapshot(*func))
        for f in fres._fields:
            assert torch.equal(getattr(fres, f), getattr(ires, f)), f
        assert np.array_equal(ires.hit.numpy(), np.asarray(jres.hit))
        assert np.array_equal(ires.value.numpy(), np.asarray(jres.value))
        for got, want in ((t_types.state_to_numpy(inplace[0]), j[0]),
                          (t_types.clients_to_numpy(inplace[1]), j[1]),
                          (t_types.stats_to_numpy(inplace[2]), j[2])):
            for f in want._fields:
                w = np.asarray(getattr(want, f))
                if w.dtype.kind != "f":
                    assert np.array_equal(got[f], w.astype(got[f].dtype)), f
                else:
                    np.testing.assert_array_max_ulp(
                        got[f], w, maxulp=16 if f in _COMPOUNDED else 4)
        set_keys = keys[g][ires.hit.numpy() & wr[g]]
        dup_sets += int(set_keys.size - np.unique(set_keys).size)
    st = inplace[2]
    assert int(st.evictions) > 0 and int(st.bucket_evictions) > 0
    assert dup_sets > 0


def test_scan_and_execute_leave_the_callers_state_untouched():
    """The trace drivers run the in-place step on their own copy of the
    carry: the caller's state, clients and stats stay as they were."""
    _, cfg = _cfgs("fused")
    keys, wr = _trace("A", n=960, seed=12)
    half = keys.shape[0] // 2
    warm = t_execute(t_make(cfg, C, 0, device="cpu"), keys[:half], plan=None,
                     is_write=wr[:half])
    c = warm.cache
    before = _snapshot(c.state, c.clients, c.stats)
    gp = t_plan.pack_rows(keys[half:], cfg.n_buckets, 4, is_write=wr[half:])
    r = t_execute(c, keys[half:], plan=gp, is_write=wr[half:])
    r2 = t_execute(c, keys[half:], plan=None, is_write=wr[half:])
    tr = t_cache._run_trace_grouped_impl(cfg, c.state, c.clients,
                                         torch.from_numpy(gp.keys.astype(
                                             np.int64)))
    assert _same_snapshots(before, _snapshot(c.state, c.clients, c.stats))
    assert int(r.stats.evictions) > 0 and int(r2.stats.evictions) > 0
    assert not _same_snapshots(before, _snapshot(tr.state, tr.clients,
                                                 c.stats))


def test_unported_options_raise():
    """Options once refused here run: the sanitizer and the replica
    (shadow) ops in the step, and the elastic runtime's drains and lane
    resize on a cluster (each returns its cache and a ``ResizeReport``)."""
    from repro_torch import elastic
    from repro_torch.dm import Cluster
    keys = torch.ones((1, C), dtype=torch.int64)
    for kw, step_kw in ((dict(sanitize=True), {}),
                        ({}, dict(shadow=torch.zeros((1, C),
                                                     dtype=torch.bool)))):
        cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=96, **kw)
        st, cl, sa = t_cache.make_cache(cfg, C, 0, "cpu")
        t_cache.access_group(cfg, st, cl, sa, keys, **step_kw)
    cluster = Cluster.make(t_types.CacheConfig(n_buckets=64, assoc=4,
                                               capacity=96), 4, 2,
                           device="cpu")
    cluster, _ = cluster.execute(torch.from_numpy(
        t_gen.zipfian(16 * 8, 200, seed=4).astype(np.int64)).view(16, 8))
    for call in (lambda: cluster.drain_to(48), lambda: cluster.with_lanes(4),
                 lambda: elastic.resize_memory(cluster.local, cluster.dm, 48),
                 lambda: elastic.resize_lanes(cluster.local, cluster.dm, 4)):
        _, report = call()
        assert isinstance(report, elastic.ResizeReport)
        assert report.migration_bytes == 0
    shrunk, report = cluster.drain_to(48)
    assert report.drain_steps >= 1
    assert bool((shrunk.dm.state.bytes_cached <= 12).all())
    assert elastic.enforce_budget(cluster.local, shrunk.dm)[1] == 0


def _stats_pair(seed: int, shape=()):
    """One OpStats in both packages from the same seeded counters."""
    rng = np.random.default_rng(seed)
    vals = [rng.integers(0, 10_000, shape) for _ in t_types.OpStats._fields]
    return (j_types.OpStats(*[jnp.asarray(v, jnp.int32) for v in vals]),
            t_types.OpStats(*[torch.from_numpy(np.asarray(v, np.int64))
                              for v in vals]))


def test_stats_sum_and_delta_match_jax():
    """``stats_sum`` reduces per-shard counters [S] to scalars and
    ``stats_delta`` takes two snapshots' difference, as the JAX
    package's; ``byte_hit_ratio`` on the results agrees too."""
    j1, t1 = _stats_pair(1, (4,))
    j2, t2 = _stats_pair(2, (4,))
    js, ts = j_types.stats_sum(j1), t_types.stats_sum(t1)
    jd = j_types.stats_delta(j_types.stats_sum(j2), js)
    td = t_types.stats_delta(t_types.stats_sum(t2), ts)
    for want, got in ((js, ts), (jd, td)):
        for f in t_types.OpStats._fields:
            assert getattr(got, f).shape == ()
            assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert t_types.byte_hit_ratio(ts) == j_types.byte_hit_ratio(js)


def test_byte_hit_ratio_matches_jax():
    """Bytes served over bytes requested on a sized trace through both
    ``execute()``s, and the guards: no traffic gives 0, and a counter
    that wrapped negative gives 0."""
    keys, sizes = t_gen.sized_zipfian(8 * 300, 500, seed=4, max_blocks=8)
    keys, sizes = keys.reshape(-1, 8), sizes.reshape(-1, 8)
    cfg_j, cfg_t = _cfgs("reference")
    jr = j_execute(j_make(cfg_j, C, 0), keys, plan=None, sizes=sizes)
    tr = t_execute(t_make(cfg_t, C, 0, device="cpu"), keys, plan=None,
                   sizes=sizes)
    got = t_types.byte_hit_ratio(tr.stats)
    assert got == j_types.byte_hit_ratio(jr.stats)
    assert 0.0 < got < t_types.hit_ratio(tr.stats) < 1.0  # big keys miss
    _, zero = _stats_pair(3)
    zero = zero._replace(hit_bytes=torch.tensor(0), miss_bytes=torch.tensor(0))
    assert t_types.byte_hit_ratio(zero) == 0.0
    wrapped = zero._replace(hit_bytes=torch.tensor(-5),
                            miss_bytes=torch.tensor(10))
    assert t_types.byte_hit_ratio(wrapped) == 0.0


def test_make_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=96)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make(cfg, C)
    assert t_make(cfg, C, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(REPO / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(mods)
    smoke = subprocess.run([sys.executable, "-c",
                            "import ast,sys; t=ast.parse(open(sys.argv[1]).read());"
                            "print(sorted({(n.module if isinstance(n, ast.ImportFrom)"
                            " else a.name).split('.')[0] for n in ast.walk(t)"
                            " if isinstance(n, (ast.Import, ast.ImportFrom))"
                            " for a in (n.names if isinstance(n, ast.Import)"
                            " else [n])}))", str(REPO / "chip_smoke.py")],
                           capture_output=True, text=True, timeout=60)
    tops = eval(smoke.stdout)
    assert "jax" not in tops and "repro" not in tops, tops


def test_windows_mark_the_first_segment_at_each_width():
    """A segment is ``compiled`` the first time its (config, width,
    lanes, device) runs: that one pays the warm-up step and, on the
    card, the step's graph capture, so the cost model skips it."""
    _, cfg = _cfgs("reference", fc_threshold=9)   # a config of this test
    keys, wr = _trace("C", n=640, seed=11)
    half = keys.shape[0] // 2
    gp = t_plan.plan_groups(keys[:half], cfg.n_buckets, 4, is_write=wr[:half])
    model = t_plan.PlanCostModel()
    r1 = t_execute(t_make(cfg, C, 0, device="cpu"), keys[:half], plan=gp,
                   is_write=wr[:half], model=model)
    r2 = t_execute(r1.cache, keys[half:], plan=None, model=model)
    r3 = t_execute(r2.cache, keys[:half], plan=gp, is_write=wr[:half],
                   model=model)
    marks = [w["compiled"] for r in (r1, r2, r3) for w in r.windows]
    assert marks == [True, True, False]
