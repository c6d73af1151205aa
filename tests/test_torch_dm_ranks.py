"""The port's DM pool spread over ranks (``Cluster.make(..., group=)``,
``repro_torch.dm.ranks``) against the one-card path and the JAX package,
on the CPU.

R = 2 and 4 ranks are ``torch.multiprocessing`` processes joined by a
``gloo`` group over a ``FileStore`` in the test's tmp dir (no network),
each holding S / R of a 4-shard pool.  Every rank runs the same calls;
each compares its block of shards with the same block of a one-card
cluster it runs beside (``Pool.block``): every ``DMCache`` leaf, weights
included, bit-equal, and the hits, global counters, reports, windows and
events equal.  A rank that raises fails the test (the other ranks are
ended).

* ``tests/test_torch_dm.py``'s four cases (``plain``, ``tenants``,
  ``replicas_l0``, ``failover``: replica election, ``inject_failure``,
  ``mark_failed`` and ``recover(rewarm=True)``) step by step on both
  backends, each step also against the JAX package's 4-device
  ``_dm_access_impl`` (its JAX child, run once in a subprocess) within
  that file's bounds: integers bit-equal, ``ext`` and ``gds_L`` 4 ulp,
  the weights and penalty sums 16;
* the handle's other paths: ``with_tenant_budgets``, ``with_capacity``,
  ``with_lanes`` both ways, ``drain_to``, ``enforce_budget``,
  ``execute(cluster, ...)``, a failure and rewarm of a shard on the last
  rank, and ``elect_replicas``;
* ``run_scenario`` with a ``HealthMonitor``, replicas re-elected every
  window, a ``WidthController`` and a fail / recover / shrink / lanes
  timeline, window by window;
* a sanitizer violation on one rank raises the same ``SanitizerError``
  on every rank, and the ranks' words keep the first failure in step
  order, as one card does.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("plain", "tenants", "replicas_l0", "failover")
WORLDS = (2, 4)
# f32 leaves that compound the exp rounding of every weight sync.
_COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def _dm_module():
    """``tests/test_torch_dm.py``: its cases and its JAX child."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_dm
    return test_torch_dm


@pytest.fixture(scope="module")
def jax_dm(tmp_path_factory):
    """The JAX package's DM cases on a 4-device mesh, as ``.npz``."""
    path = tmp_path_factory.mktemp("dm_ranks") / "jax_dm.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _dm_module()._JAX_CHILD, str(path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return str(path)


def _spawn(what: str, world: int, tmp_path, *args) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_worker, args=(world, str(tmp_path / "store"), what,
                                      args),
                       nprocs=world, join=True, start_method="spawn")


def _worker(rank: int, world: int, store: str, what: str, args) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        globals()[what](dist.group.WORLD, *args)
    finally:
        dist.destroy_process_group()


def _same(tag: str, want, got) -> None:
    """Two DMCaches (or blocks) bit-equal, leaf by leaf."""
    for part, a, b in zip(("state", "clients", "stats"), want, got):
        for f, x, y in zip(a._fields, a, b):
            assert x.shape == y.shape and torch.equal(x, y), (tag, part, f)


def _close_to_jax(tag: str, got: dict, want: dict, prefix: str, pool):
    """A rank's leaves against its block of the JAX package's, within
    ``tests/test_torch_dm.py``'s bounds."""
    S = pool.n_shards
    for part in ("state", "clients", "stats"):
        for f, g in got[part].items():
            w = want[f"{prefix}/{part}/{f}"]
            m = w.shape[0] // S
            w = w[pool.lo * m:pool.hi * m]
            assert g.shape == w.shape, (tag, part, f, g.shape, w.shape)
            if w.dtype.kind == "f":
                np.testing.assert_array_max_ulp(
                    g, w, maxulp=16 if f in _COMPOUNDED else 4)
            else:
                assert np.array_equal(g.astype(np.int64),
                                      w.astype(np.int64)), (tag, part, f)


def _jax_tree(want: dict, prefix: str) -> dict:
    out = {"state": {}, "clients": {}, "stats": {}}
    for k, v in want.items():
        if k.startswith(prefix + "/") and k.count("/") == prefix.count("/") + 2:
            part, f = k.split("/")[-2:]
            out[part][f] = v
    return out


def _ints(stats) -> list:
    return [int(x) for x in stats]


def _t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _cases(group, backend: str, npz: str, cases_src: str) -> None:
    """test_torch_dm.py's four cases, step by step, against the one-card
    path (bit-equal) and the JAX package (its bounds)."""
    from repro_torch.core import types as t_types
    from repro_torch.dm import Cluster
    from repro_torch.dm import sharded_cache as sc
    from repro_torch.workloads import gen
    ns: dict = {}
    exec(cases_src, ns)
    S, LANES, STEPS = ns["S"], ns["LANES"], ns["STEPS"]
    want = dict(np.load(npz))
    keys, wr, sz, ten = ns["trace"](gen)
    for case in CASES:
        cfg = t_types.CacheConfig(**ns["case_kw"](case, backend))
        one = Cluster.make(cfg, S, LANES, seed=5, device="cpu")
        mine = Cluster.make(cfg, S, LANES, seed=5, device="cpu", group=group)
        pool = mine.pool
        _same(f"{case} make", pool.block(one.dm), mine.dm)
        init = t_types.dm_from_numpy(_jax_tree(want, case + "/init"), "cpu")
        one, mine = one._replace(dm=init), mine._replace(dm=pool.block(init))
        loads = [np.zeros(cfg.n_buckets), np.zeros(cfg.n_buckets)]
        reports: list = [{}, {}]
        for t in range(STEPS):
            one = ns["events"](case, t, one, loads[0], reports[0])
            mine = ns["events"](case, t, mine, loads[1], reports[1])
            m = mine.membership()
            for a, b in zip(one.membership(), m):
                assert torch.equal(a, b), (case, t)
            args = (_t64(keys[t]), torch.as_tensor(wr[t]), _t64(sz[t]),
                    _t64(ten[t]))
            kw = dict(route_factor=ns["route_factor"](case), member=m)
            d1, h1 = sc._dm_access_impl(one.local, one.dm, *args, **kw)
            d2, h2 = sc._dm_access_impl(mine.local, mine.dm, *args, **kw,
                                        pool=pool)
            one, mine = one._replace(dm=d1), mine._replace(dm=d2)
            assert torch.equal(h1, h2), (case, t)
            _same(f"{case} step {t}", pool.block(d1), d2)
            assert np.array_equal(h2.numpy(), want[f"{case}/{t}/hits"])
            _close_to_jax(f"{case} step {t}", t_types.dm_to_numpy(d2), want,
                          f"{case}/{t}", pool)
            for ld in loads:
                ns["add_loads"](gen, keys[t], cfg.n_buckets, ld)
        assert _ints(one.stats) == _ints(mine.stats), case
        if case == "failover":
            for rep in reports:
                assert np.array_equal(rep["failover/report"],
                                      want["failover/report"])


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("world", WORLDS)
def test_dm_cases_on_ranks_equal_one_card_and_jax(jax_dm, world, backend,
                                                  tmp_path):
    _spawn("_cases", world, tmp_path, backend, jax_dm,
           _dm_module()._CASES_SRC)


def _cluster_paths(group) -> None:
    """The handle's paths, one after another, on a two-tenant pool; the
    rank's block equal to the one-card cluster's after each."""
    from repro_torch import elastic
    from repro_torch.core import execute
    from repro_torch.core.types import CacheConfig
    from repro_torch.dm import Cluster
    from repro_torch.workloads import gen
    S = 4
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, n_tenants=2,
                      tenant_budget_blocks=(100, 92), sync_period=8)
    rng = np.random.default_rng(4)
    cls = [Cluster.make(cfg, S, 8, seed=3, device="cpu"),
           Cluster.make(cfg, S, 8, seed=3, device="cpu", group=group)]
    pool = cls[1].pool

    def check(tag, outs=()):
        _same(tag, pool.block(cls[0].dm), cls[1].dm)
        assert _ints(cls[0].stats) == _ints(cls[1].stats), tag
        for a, b in outs:
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), (tag, a, b)

    def run(tag, lanes, n=12):
        keys = gen.zipfian(n * S * lanes, 300, 0.9,
                           int(rng.integers(1 << 30))).reshape(n, S * lanes)
        wr = rng.random(keys.shape) < 0.3
        size = rng.integers(1, 6, keys.shape)
        outs = [c.execute(_t64(keys), torch.as_tensor(wr), _t64(size),
                          _t64(keys % 2)) for c in cls]
        for i, (c, _) in enumerate(outs):
            cls[i] = c
        check(tag, [(outs[0][1], outs[1][1])])
        return keys

    def each(tag, fn):
        """``fn`` on both clusters: a Cluster, or (Cluster, a result)."""
        outs = [fn(c) for c in cls]
        paired = type(outs[0]) is tuple
        for i, o in enumerate(outs):
            cls[i] = o[0] if paired else o
        check(tag, [(outs[0][1], outs[1][1])] if paired else ())

    run("warm", 8, 16)
    each("budgets", lambda c: c.with_tenant_budgets((70, 60)))
    each("capacity", lambda c: c.with_capacity(160))
    each("lanes up", lambda c: c.with_lanes(12))
    run("at 12 lanes", 12)
    each("drain", lambda c: c.drain_to(64, batch_per_shard=4))
    assert bool((cls[1].dm.state.bytes_cached <= 16).all())
    each("lanes down", lambda c: c.with_lanes(4))
    keys = run("at 4 lanes", 4)
    each("over budget", lambda c: c.with_capacity(32))
    def enforce(c):
        dm, n = elastic.enforce_budget(c.local, c.dm, batch_per_shard=2,
                                       pool=c.pool)
        return c._replace(dm=dm), n

    each("enforce", enforce)
    each("capacity back", lambda c: c.with_capacity(192))
    res = [execute(c, keys) for c in cls]
    for f in ("hits", "ops"):
        assert np.array_equal(getattr(res[0], f), getattr(res[1], f)), f
    assert res[0].hit_rate == res[1].hit_rate
    cls = [r.cache for r in res]
    check("execute()")
    last = S - 1                          # held by the last rank
    each("failure", lambda c: c.inject_failure(last))
    run("failed, routed", 4)
    each("marked", lambda c: c.mark_failed(last))
    run("failed, rerouted", 4)
    each("rewarm", lambda c: c.recover(last, rewarm=True))
    loads = np.bincount(gen._mix32(keys.ravel()) % cfg.n_buckets,
                        minlength=cfg.n_buckets).astype(np.float64)
    each("replicas", lambda c: c.elect_replicas(loads, 12))
    run("replicated", 4)


@pytest.mark.parametrize("world", WORLDS)
def test_cluster_paths_on_ranks_equal_one_card(world, tmp_path):
    _spawn("_cluster_paths", world, tmp_path)


def _scenario(group) -> None:
    """``run_scenario`` on ranks and on one card: every window and
    event, and the final block."""
    from repro_torch.core.types import CacheConfig
    from repro_torch.elastic import HealthMonitor, run_scenario
    from repro_torch.elastic.controller import WidthController
    from repro_torch.workloads import gen
    S, lanes, W = 4, 8, 8
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=16)
    keys = gen.failover_trace(64, lanes, S, cfg.n_buckets, hot_shard=1,
                              hot_fraction=0.7, n_hot=12, n_keys=400, seed=2)
    timeline = [(16, ("fail_shard", 1)), (40, ("recover_shard", 1)),
                (48, ("set_capacity", 48)), (56, ("set_lanes", 6))]
    res = [run_scenario(cfg, keys.ravel(), timeline, n_shards=S,
                        lanes_per_shard=lanes, horizon=64, window=W,
                        health=HealthMonitor(S), replicate_hot=6, seed=7,
                        width_controller=WidthController(), device="cpu",
                        group=g) for g in (None, group)]
    assert res[0].windows == res[1].windows
    assert res[0].events == res[1].events
    assert any(e["event"] == "mark_failed" for e in res[1].events)
    _same("scenario", res[1].cluster.pool.block(res[0].dm), res[1].dm)


@pytest.mark.parametrize("world", WORLDS)
def test_run_scenario_on_ranks_equals_one_card(world, tmp_path):
    _spawn("_scenario", world, tmp_path)


def _sanitizer(group) -> None:
    """A duplicated live key in one bucket of the last shard, on the last
    rank only: every rank raises SAN003.  The pool never fills (no
    batched eviction drift past a budget, SAN002) and syncs every step
    (between syncs a lane's local weights leave the simplex, SAN004, as
    in the JAX package), so the clean pool raises nothing."""
    import dataclasses
    from repro_torch.analysis.sanitize import SanitizerError
    from repro_torch.core.types import CacheConfig
    from repro_torch.dm import Cluster
    from repro_torch.workloads import gen
    cfg = CacheConfig(n_buckets=256, assoc=4, capacity=512, sync_period=1)
    keys = _t64(gen.zipfian(16 * 32, 300, 0.9, 1).reshape(16, 32))
    cl = Cluster.make(cfg, 4, 8, device="cpu", group=group)
    cl, _ = cl.execute(keys)
    pool, ls, A = cl.pool, cl.local.n_slots, cfg.assoc
    key = cl.dm.state.key.clone()
    if pool.rank == pool.n_ranks - 1:
        size = cl.dm.state.size[-ls:]
        live = ((size != 0) & (size != 255)).reshape(-1, A)
        b = int(torch.nonzero(live.sum(dim=1) >= 2)[0, 0])
        i, j = (key.shape[0] - ls + b * A
                + torch.nonzero(live[b])[:2, 0]).tolist()
        key[j] = key[i]
    bad = cl._replace(local=dataclasses.replace(cl.local, sanitize=True),
                      dm=cl.dm._replace(state=cl.dm.state._replace(key=key)))
    with pytest.raises(SanitizerError, match="^SAN003"):
        bad.execute(keys[:4])
    # The same calls armed on the clean pool raise nothing.
    bad._replace(dm=cl.dm).execute(keys[:4])


@pytest.mark.parametrize("world", WORLDS)
def test_sanitizer_violation_on_one_rank_raises_on_all(world, tmp_path):
    _spawn("_sanitizer", world, tmp_path)


def _word_order(group) -> None:
    """The words shared between groups keep the first failure in step
    order, as one card carries it: the last rank fails at group 2
    (check 5), rank 0 at group 5 (check 1), and every rank ends with
    check 5, the one-card word, not the first by rank."""
    from repro_torch.analysis import sanitize
    from repro_torch.dm import ranks
    from repro_torch.dm.sharded_cache import PendingSync, _share_sync
    import torch.distributed as dist
    pool = ranks.make_pool(group, 2 * dist.get_world_size(group),
                           torch.device("cpu"))
    last = pool.rank == pool.n_ranks - 1
    fails = {2: 5} if last else {5: 1} if pool.rank == 0 else {}
    between = _share_sync(pool)
    pen = torch.zeros((pool.n_local, 2))
    carry = (None, None, None, None, None,
             sanitize.Word(sanitize.new_word("cpu")))
    for g in range(8):
        sanitize.merge_(carry[-1].word, torch.tensor(fails.get(g, 0)))
        carry = between(carry, (None, torch.tensor(False), pen))
        assert isinstance(carry[4], PendingSync)
        assert int(carry[-1].word) == (5 if g >= 2 else 0), (pool.rank, g)


@pytest.mark.parametrize("world", WORLDS)
def test_shared_words_keep_the_first_failure_in_step_order(world, tmp_path):
    _spawn("_word_order", world, tmp_path)


def test_pool_refuses_a_layout_it_cannot_hold(tmp_path):
    """R must divide S, and the group must be initialized."""
    from repro_torch.core.types import CacheConfig
    from repro_torch.dm import Cluster
    from repro_torch.dm import ranks
    import torch.distributed as dist
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=96)
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="not initialized"):
            Cluster.make(cfg, 4, 8, device="cpu", group=object())
    _spawn("_refusals", 2, tmp_path)
    p = ranks.Pool(None, 2, 1, 4, "gloo")
    assert (p.n_local, p.lo, p.hi, p.owner(1), p.owner(3)) == (2, 2, 4, 0, 1)


def _refusals(group) -> None:
    from repro_torch.core.types import CacheConfig
    from repro_torch.dm import Cluster
    cfg = CacheConfig(n_buckets=96, assoc=4, capacity=96)
    with pytest.raises(ValueError, match="do not divide"):
        Cluster.make(cfg, 3, 8, device="cpu", group=group)
    with pytest.raises(TypeError, match="integers only"):
        Cluster.make(cfg, 2, 8, device="cpu", group=group).pool.sum_(
            torch.ones(2))
