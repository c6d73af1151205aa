"""The port's elastic runtime (``repro_torch.elastic``: the shrink drain,
the lane resize, the controllers and the scenario driver) against the
JAX package, on the CPU.

In process, at one shard (as ``tests/test_elastic.py`` runs):

* every case of ``tests/test_elastic.py``'s 13 tests, run through both
  packages from the same config and seed: each step's hits, the
  ``DMCache`` leaves after every resize and at the end, each
  ``ResizeReport``, and the scenario driver's window dicts and event log
  (equal as Python values);
* the drain with each expert of ``ALL_ALGORITHMS`` as the dominant one,
  from the JAX package's warmed state carried across: the drained slots,
  every leaf and the report bit-equal;
* the ``Autoscaler``, ``WidthController``, ``TenantArbiter`` and
  ``HealthMonitor`` decision sequences on the same seeded metric
  streams, and ``tests/test_cluster.py``'s two ``HealthMonitor`` cases;
* the three generators ``changing_workload``, ``loop_window`` and
  ``mixed_apps``.

At four shards the JAX package needs a 4-device mesh, so one
module-scoped fixture runs its cases in ONE subprocess (the pattern of
``tests/test_torch_dm.py``) and writes an ``.npz``: the drain with two
tenants, whose weights are [T, E] and vote as their tenant mean;
``resize_lanes`` in both directions; and ``run_scenario`` with a
``HealthMonitor``, ``replicate_hot`` and a ``fail_shard`` /
``recover_shard`` / ``set_capacity`` timeline.  The drain and the lane
resize start from the JAX state carried across.

Tolerance: integers bit-equal; ``ext`` and ``gds_L`` within 4 ulp, and
the expert weights and penalty sums, which compound every sync's ``exp``,
within 16 (as ``tests/test_torch_dm.py``).  A drain or a lane resize
from a carried state is bit-equal in every leaf.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import elastic as j_el
from repro.core import CacheConfig as JConfig
from repro.core.priority import ALL_ALGORITHMS
from repro.dm import Cluster as JCluster
from repro.dm import sharded_cache as j_sc
from repro.elastic import controller as j_ctl
from repro.workloads import gen as j_gen
from repro_torch import elastic as t_el
from repro_torch.core import types as t_types
from repro_torch.dm import Cluster as TCluster
from repro_torch.dm import sharded_cache as t_sc
from repro_torch.elastic import controller as t_ctl
from repro_torch.workloads import gen as t_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def _leaves(dm) -> dict:
    """A DMCache of either package as {part/field: numpy}."""
    out = {}
    for part in ("state", "clients", "stats"):
        tree = getattr(dm, part)
        for f in tree._fields:
            x = getattr(tree, f)
            out[f"{part}/{f}"] = (x.numpy() if isinstance(x, torch.Tensor)
                                  else np.asarray(x))
    return out


def _same_dm(want, got, tag: str, exact: bool = False) -> None:
    """Integers bit-equal; f32 within 4 ulp (the compounded leaves 16),
    or bit-equal with ``exact``."""
    w, g = (want if isinstance(want, dict) else _leaves(want)), _leaves(got)
    assert set(w) == set(g), tag
    for k, a in w.items():
        b = g[k]
        assert a.shape == b.shape, (tag, k, a.shape, b.shape)
        if a.dtype.kind == "f":
            if exact:
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                    (tag, k)
            else:
                np.testing.assert_array_max_ulp(
                    b, a, maxulp=16 if k.split("/")[1] in _COMPOUNDED else 4)
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                (tag, k)


class Pair:
    """One sharded cache in each package, from the same config and seed,
    stepped with the same request rounds (``_dm_access_impl``)."""

    def __init__(self, n_shards=1, lanes=8, **kw):
        self.jcl = JCluster.make(JConfig(**kw), n_shards, lanes)
        self.tcl = TCluster.make(t_types.CacheConfig(**kw), n_shards, lanes,
                                 device="cpu")
        self.jdm, self.tdm = self.jcl.dm, self.tcl.dm
        self.local = self.tcl.local
        self._step = jax.jit(functools.partial(j_sc._dm_access_impl,
                                               self.jcl.mesh, self.jcl.local))

    def step(self, keys) -> None:
        self.jdm, jh = self._step(self.jdm, jnp.asarray(keys, jnp.uint32))
        self.tdm, th = t_sc._dm_access_impl(
            self.local, self.tdm, torch.from_numpy(
                np.asarray(keys).astype(np.int64)))
        assert np.array_equal(np.asarray(jh), th.numpy())

    def same(self, tag: str) -> None:
        _same_dm(self.jdm, self.tdm, tag)

    def resize_memory(self, cap, **kw):
        self.jdm, jrep = j_el.resize_memory(self.jcl.mesh, self.jcl.local,
                                            self.jdm, cap, **kw)
        self.tdm, trep = t_el.resize_memory(self.local, self.tdm, cap, **kw)
        assert tuple(jrep) == tuple(trep), (jrep, trep)
        self.same(f"resize_memory({cap})")
        return trep

    def resize_lanes(self, lanes, **kw):
        self.jdm, jrep = j_el.resize_lanes(self.jcl.mesh, self.jcl.local,
                                           self.jdm, lanes, **kw)
        self.tdm, trep = t_el.resize_lanes(self.local, self.tdm, lanes, **kw)
        assert tuple(jrep) == tuple(trep), (jrep, trep)
        self.same(f"resize_lanes({lanes})")
        return trep


def _small(capacity=256, lanes=8, experts=("lru", "lfu")):
    return Pair(lanes=lanes, n_buckets=256, assoc=8, capacity=capacity,
                experts=experts)


# ----------------------------------------------------------------------
# tests/test_elastic.py's 13 cases, through both packages.
# ----------------------------------------------------------------------

def _grow():
    p = _small()
    keys = j_gen.zipfian(8 * 100, 2_000, seed=0).reshape(100, 8)
    for t in range(100):
        p.step(keys[t])
    p.same("warm")
    before = _leaves(p.tdm)
    rep = p.resize_memory(512)
    assert rep == (0, 0, 0, 0)
    for name in ("key", "size", "ptr", "values", "freq", "last_ts"):
        assert np.array_equal(before["state/" + name],
                              p.tdm.state.__getattribute__(name).numpy())
    assert int(p.tdm.state.capacity_blocks[0]) == 512


def _shrink_bounded():
    p = _small(capacity=256)
    keys = j_gen.zipfian(8 * 200, 2_000, seed=1).reshape(200, 8)
    for t in range(100):
        p.step(keys[t])
    assert int(p.tdm.state.n_cached[0]) > 128
    rep = p.resize_memory(128, batch_per_shard=16)
    assert rep.migration_bytes == 0 and 1 <= rep.drain_steps <= 256
    assert int(p.tdm.state.n_cached[0]) <= 128
    for t in range(100, 200):
        p.step(keys[t])
        assert int(p.tdm.state.n_cached[0]) <= 128 + 2 * 8
    p.same("after the shrink")


def _lowest_priority_first():
    p = Pair(lanes=1, n_buckets=64, assoc=8, capacity=64, experts=("lru",))
    for k in range(1, 65):
        p.step(np.asarray([k], np.uint32))
    rep = p.resize_memory(32, batch_per_shard=8)
    size = p.tdm.state.size.numpy()
    live = (size != 0) & (size != 0xFF)
    assert set(p.tdm.state.key.numpy()[live].tolist()) == set(range(33, 65))
    assert rep.drained_objects == 32 and rep.drain_steps == 4


def _dm_set_capacity():
    p = _small()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jdm = j_sc.dm_set_capacity(p.jdm, 128, 1)
        tdm = t_sc.dm_set_capacity(p.tdm, 128, 1)
    _same_dm(jdm, tdm, "dm_set_capacity")
    assert int(tdm.state.capacity_blocks[0]) == 128


def _lane_grow():
    p = _small(lanes=4)
    keys = j_gen.zipfian(4 * 80, 500, seed=2).reshape(80, 4)
    for t in range(80):
        p.step(keys[t])
    old_lw = p.tdm.clients.local_weights.numpy().copy()
    assert p.resize_lanes(8).migration_bytes == 0
    lw = p.tdm.clients.local_weights.numpy()
    assert lw.shape[0] == 8 and np.array_equal(lw[:4], old_lw)
    assert (p.tdm.clients.fc_slot.numpy()[4:] == -1).all()
    p.step(j_gen.zipfian(8, 500, seed=3))
    p.same("a step at the new width")


def _lane_shrink():
    p = _small(lanes=8)
    keys = j_gen.zipfian(8 * 120, 300, seed=4).reshape(120, 8)
    for t in range(120):
        p.step(keys[t])
    cl = p.tdm.clients
    pending = cl.fc_delta.numpy()[4:][cl.fc_slot.numpy()[4:] >= 0].sum()
    freq_before = p.tdm.state.freq.numpy().sum()
    p.resize_lanes(4)
    assert p.tdm.clients.fc_slot.shape[0] == 4
    assert p.tdm.state.freq.numpy().sum() == freq_before + pending
    for t in range(20):
        p.step(keys[t, :4])
    p.same("steps after the shrink")


def _steady(mod, hr, ev=0.0, drops=0.0, nc=900, cap=1024, lanes=8,
            util=None):
    return mod.WindowMetrics(hit_rate=hr, evictions_per_op=ev,
                             insert_drops_per_op=drops, n_cached=nc,
                             capacity=cap, lanes=lanes, offered_mops=util,
                             tput_mops=1.0)


def _same_decisions(cfg_kw: dict, windows: list) -> list:
    """Both packages' Autoscalers over the same windows (``_steady``
    keyword sets): equal decisions and logs.  Returns the actions."""
    jc = j_ctl.Autoscaler(j_ctl.AutoscalerConfig(**cfg_kw))
    tc = t_ctl.Autoscaler(t_ctl.AutoscalerConfig(**cfg_kw))
    acts = []
    for kw in windows:
        jd = jc.observe(_steady(j_ctl, **kw))
        td = tc.observe(_steady(t_ctl, **kw))
        assert tuple(jd) == tuple(td), (kw, jd, td)
        acts.append(td.action)
    assert [tuple(d) for d in jc.log] == [tuple(d) for d in tc.log]
    return acts


def _controller_steady():
    acts = _same_decisions(dict(patience=2, cooldown=3),
                           [dict(hr=0.88, nc=900)] * 100)
    assert set(acts) == {"none"}
    acts = _same_decisions(dict(patience=2, cooldown=3),
                           [dict(hr=0.5, ev=0.1)] * 100)
    assert "shrink_memory" not in acts and "grow_memory" in acts


def _controller_triggers():
    assert "grow_memory" in _same_decisions(
        dict(patience=2, cooldown=2), [dict(hr=0.5, ev=0.1, cap=1024)] * 3)
    assert "shrink_memory" in _same_decisions(
        dict(patience=2, cooldown=2), [dict(hr=0.95, nc=100, cap=4096)] * 3)


def _controller_lanes():
    assert "grow_lanes" in _same_decisions(
        dict(patience=2, cooldown=2), [dict(hr=0.9, util=0.95)] * 3)
    assert "shrink_lanes" in _same_decisions(
        dict(patience=2, cooldown=2), [dict(hr=0.9, util=0.1)] * 3)


def _controller_cooldown():
    acts = _same_decisions(dict(patience=1, cooldown=4),
                           [dict(hr=0.5, ev=0.1)] * 5)
    assert acts == ["grow_memory"] + ["none"] * 4


def _same_scenario(cfg_kw: dict, keys, timeline, jkw=None, tkw=None, **kw):
    """``run_scenario`` through both packages: equal window dicts and
    event logs, and the final caches' leaves.  ``jkw``/``tkw``: each
    side's own arguments (controllers)."""
    jr = j_el.run_scenario(JConfig(**cfg_kw), keys, timeline,
                           **kw, **(jkw or {}))
    tr = t_el.run_scenario(t_types.CacheConfig(**cfg_kw), keys, timeline,
                           device="cpu", **kw, **(tkw or {}))
    assert len(jr.windows) == len(tr.windows)
    for i, (jw, tw) in enumerate(zip(jr.windows, tr.windows)):
        assert jw == tw, (i, {k: (jw[k], tw[k]) for k in jw
                              if jw[k] != tw[k]})
    assert jr.events == tr.events
    _same_dm(jr.dm, tr.dm, "final cache")
    assert tr.cluster.lanes_per_shard == jr.cluster.lanes_per_shard
    return tr


def _scenario_resize():
    cfg = dict(n_buckets=256, assoc=8, capacity=512, experts=("lru", "lfu"))
    res = _same_scenario(cfg, j_gen.zipfian(8 * 300, 3_000, seed=0),
                         [(100, ("set_capacity", 1024)),
                          (200, ("set_capacity", 128))],
                         n_shards=1, lanes_per_shard=8, horizon=300,
                         window=20)
    grow, shrink = res.events
    assert grow["report"]["migration_bytes"] == 0
    assert grow["report"]["drain_steps"] == 0
    assert 1 <= shrink["report"]["drain_steps"] <= 256
    for w in res.windows:
        if w["t0"] >= 220:
            assert w["n_cached"] <= 128 + 8 and w["capacity"] == 128


def _scenario_lanes_workload():
    cfg = dict(n_buckets=256, assoc=8, capacity=256, experts=("lru", "lfu"))
    res = _same_scenario(
        cfg, j_gen.zipfian(4 * 200, 2_000, seed=1),
        [(50, ("set_lanes", 8)), (100, ("switch_workload", "hot"))],
        n_shards=1, lanes_per_shard=4, horizon=200, window=25,
        workloads={"hot": j_gen.zipfian(2_000, 100, seed=2)})
    assert res.windows[0]["lanes"] == 4 and res.windows[-1]["lanes"] == 8
    assert res.windows[-1]["hit_rate"] > 0.9


def _scenario_autoscaler():
    cfg = dict(n_buckets=2048, assoc=8, capacity=512, experts=("lru", "lfu"))
    ctl = dict(hit_rate_floor=0.9, patience=2, cooldown=2, min_capacity=256,
               max_capacity=4096)
    res = _same_scenario(
        cfg, j_gen.zipfian(8 * 400, 2_000, seed=3), [],
        jkw=dict(controller=j_ctl.Autoscaler(j_ctl.AutoscalerConfig(**ctl))),
        tkw=dict(controller=t_ctl.Autoscaler(t_ctl.AutoscalerConfig(**ctl))),
        n_shards=1, lanes_per_shard=8, horizon=400, window=25)
    assert [e for e in res.events if e["event"] == "set_capacity"]
    assert res.windows[-1]["capacity"] > 512


ELASTIC_CASES = {
    "test_grow_is_zero_migration_scalar_write": _grow,
    "test_shrink_drains_and_every_step_stays_bounded": _shrink_bounded,
    "test_shrink_evicts_lowest_priority_first": _lowest_priority_first,
    "test_dm_set_capacity_delegates_to_elastic": _dm_set_capacity,
    "test_lane_grow_carries_state_and_inits_new_lanes": _lane_grow,
    "test_lane_shrink_flushes_decommissioned_state": _lane_shrink,
    "test_controller_steady_workload_never_oscillates": _controller_steady,
    "test_controller_grow_and_shrink_triggers": _controller_triggers,
    "test_controller_lane_scaling_by_utilization": _controller_lanes,
    "test_controller_cooldown_quiets_after_action": _controller_cooldown,
    "test_scenario_reproduces_elastic_resize_semantics": _scenario_resize,
    "test_scenario_switch_workload_and_lanes": _scenario_lanes_workload,
    "test_scenario_closed_loop_autoscaler_acts": _scenario_autoscaler,
}


@pytest.mark.parametrize("case", list(ELASTIC_CASES))
def test_elastic_case_matches_jax(case):
    ELASTIC_CASES[case]()


# ----------------------------------------------------------------------
# The drain under each expert as the dominant one.
# ----------------------------------------------------------------------

_ALL_KW = dict(n_buckets=64, assoc=8, capacity=160, experts=ALL_ALGORITHMS,
               backend="reference")


@pytest.fixture(scope="module")
def warmed_all_experts():
    """A JAX cache with every expert, warmed by sized requests with
    writes, so every ext field moves."""
    cl = JCluster.make(JConfig(**_ALL_KW), 1, 8)
    step = jax.jit(functools.partial(j_sc._dm_access_impl, cl.mesh, cl.local))
    rng = np.random.default_rng(7)
    keys = j_gen.zipfian(8 * 60, 600, 0.9, seed=8).reshape(60, 8)
    dm = cl.dm
    for t in range(60):
        dm, _ = step(dm, jnp.asarray(keys[t]),
                     jnp.asarray(rng.random(8) < 0.3),
                     jnp.asarray(rng.integers(1, 8, 8), jnp.uint32))
    return cl, dm


@pytest.mark.parametrize("expert", ALL_ALGORITHMS)
def test_drain_under_each_dominant_expert_matches_jax(warmed_all_experts,
                                                      expert):
    """The warmed cache with the weights set so ``expert`` dominates,
    then a shrink drain in each package from that state: the same
    victims, every leaf and the report bit-equal."""
    cl, dm = warmed_all_experts
    E = len(ALL_ALGORITHMS)
    w = np.full((1, E), 0.5 / (E - 1), np.float32)
    w[0, ALL_ALGORITHMS.index(expert)] = 0.5
    dm = dm._replace(state=dm.state._replace(weights=jnp.asarray(w)))
    assert int(np.asarray(dm.state.bytes_cached)[0]) > 96
    jdm, jrep = j_el.resize_memory(cl.mesh, cl.local, dm, 96,
                                   batch_per_shard=8)
    tlocal = TCluster.make(t_types.CacheConfig(**_ALL_KW), 1, 8,
                           device="cpu").local
    tdm, trep = t_el.resize_memory(
        tlocal, t_types.dm_from_numpy(dm, device="cpu"), 96,
        batch_per_shard=8)
    assert tuple(jrep) == tuple(trep) and trep.drain_steps >= 2
    _same_dm(jdm, tdm, f"drain under {expert}", exact=True)


def test_measured_migration_bytes_match_jax():
    """The migration measure on seeded before/after tables of four shards
    where keys stay, vanish, appear, move between shards and stand as
    replicas on several: the JAX package's count."""
    from types import SimpleNamespace
    from repro.elastic import resize as j_rz
    from repro_torch.elastic import resize as t_rz
    rng = np.random.default_rng(9)
    moved = []
    for i in range(20):
        n = 64
        key_b = rng.integers(1, 24, n).astype(np.uint32)
        size_b = rng.choice(np.uint32([0, 255, 1, 3, 7]), n)
        key_a = np.where(rng.random(n) < 0.7, key_b,
                         rng.integers(1, 24, n)).astype(np.uint32)
        size_a = np.where(rng.random(n) < 0.7, size_b,
                          rng.choice(np.uint32([0, 255, 2, 5]), n))
        if i % 2:                       # a drain: slots only empty
            key_a = key_b
            size_a = np.where(rng.random(n) < 0.7, size_b, 0)
        before = dict(key=key_b, size=size_b, shards=4, value_words=2)
        after = SimpleNamespace(state=SimpleNamespace(key=key_a,
                                                      size=size_a))
        want = j_rz._measured_migration_bytes(before, after)
        t_before = dict(before, key=key_b.astype(np.int64),
                        size=size_b.astype(np.int64))
        t_after = SimpleNamespace(state=SimpleNamespace(
            key=torch.from_numpy(key_a.astype(np.int64)),
            size=torch.from_numpy(size_a.astype(np.int64))))
        assert t_rz._measured_migration_bytes(t_before, t_after) == want
        moved.append(want)
    assert min(moved) == 0 < max(moved)


def test_stuck_drain_raises_as_jax_does():
    """A drain that cannot reach the new capacity in ``max_steps`` raises
    ``RuntimeError`` with the JAX package's message, and leaves the
    caller's cache as it was."""
    p = _small()
    keys = j_gen.zipfian(8 * 60, 2_000, seed=5).reshape(60, 8)
    for t in range(60):
        p.step(keys[t])
    msgs = []
    for call in (lambda: j_el.resize_memory(p.jcl.mesh, p.jcl.local, p.jdm,
                                            16, batch_per_shard=2,
                                            max_steps=3),
                 lambda: t_el.resize_memory(p.local, p.tdm, 16,
                                            batch_per_shard=2, max_steps=3)):
        with pytest.raises(RuntimeError) as err:
            call()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "did not reach capacity=16" in msgs[1]
    p.same("the caller's cache after the stuck drain")
    assert int(p.tdm.state.capacity_blocks[0]) == 256


# ----------------------------------------------------------------------
# Controllers on seeded metric streams.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_decisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(patience=int(rng.integers(1, 4)),
               cooldown=int(rng.integers(0, 5)), min_capacity=256,
               max_capacity=1 << 16)
    jc = j_ctl.Autoscaler(j_ctl.AutoscalerConfig(**cfg))
    tc = t_ctl.Autoscaler(t_ctl.AutoscalerConfig(**cfg))
    cap = 4096
    for _ in range(300):
        kw = dict(hit_rate=float(rng.random()),
                  evictions_per_op=float(rng.random() * 0.05),
                  insert_drops_per_op=float(rng.random() * 0.03),
                  n_cached=int(rng.integers(0, cap)), capacity=cap,
                  lanes=int(rng.choice([8, 16, 32])),
                  offered_mops=(None if rng.random() < 0.2
                                else float(rng.random() * 2)),
                  tput_mops=float(rng.random() * 2),
                  blocks_cached=int(rng.integers(0, 2 * cap)),
                  capacity_blocks=int(rng.choice([0, cap])))
        jd = jc.observe(j_ctl.WindowMetrics(**kw))
        td = tc.observe(t_ctl.WindowMetrics(**kw))
        assert tuple(jd) == tuple(td)
        assert t_ctl.WindowMetrics(**kw).occupancy == \
            j_ctl.WindowMetrics(**kw).occupancy
        if td.action.endswith("memory"):
            cap = td.target
    assert [tuple(d) for d in jc.log] == [tuple(d) for d in tc.log]


def test_window_metrics_from_stats_match_jax():
    from repro.core import types as j_types
    rng = np.random.default_rng(5)
    for _ in range(20):
        vals = rng.integers(0, 1000, len(j_types.OpStats._fields))
        j = j_ctl.WindowMetrics.from_stats(
            j_types.OpStats(*[np.int64(v) for v in vals]), n_cached=10,
            capacity=20, lanes=8, blocks_cached=30, capacity_blocks=40)
        t = t_ctl.WindowMetrics.from_stats(
            t_types.OpStats(*[int(v) for v in vals]), n_cached=10,
            capacity=20, lanes=8, blocks_cached=30, capacity_blocks=40)
        assert tuple(j) == tuple(t)


def test_width_controller_matches_jax():
    rng = np.random.default_rng(3)
    jw, tw = j_ctl.WidthController(), t_ctl.WidthController()
    for _ in range(200):
        w = jw.width
        assert tw.width == w
        wall = (130 + 50 * w) * 1e-6 * float(rng.uniform(0.5, 1.5)) \
            * (0.5 if w >= 16 else 1.0)
        jw.observe_chunk(w, wall)
        tw.observe_chunk(w, wall)
        assert jw.propose() == tw.propose()
    assert jw.log == tw.log and len(tw.log) > 0


def test_tenant_arbiter_matches_jax():
    rng = np.random.default_rng(4)
    for cfg in (dict(), dict(floor_frac=0.2, ema=1.0, min_change_frac=0.0)):
        ja = j_ctl.TenantArbiter(j_ctl.TenantArbiterConfig(**cfg))
        ta = t_ctl.TenantArbiter(t_ctl.TenantArbiterConfig(**cfg))
        budgets = [1000, 1000, 1000]
        for _ in range(60):
            ws = [dict(occupancy_blocks=int(rng.integers(0, 1200)),
                       budget_blocks=b, hit_rate=float(rng.random()),
                       miss_blocks=float(rng.random() * 500))
                  for b in budgets]
            jp = ja.propose(3000, [j_ctl.TenantWindow(**w) for w in ws])
            tp = ta.propose(3000, [t_ctl.TenantWindow(**w) for w in ws])
            assert jp == tp
            if tp is not None:
                budgets = list(tp)
        assert ja.log == ta.log and len(ta.log) > 0


def test_health_monitor_matches_jax():
    rng = np.random.default_rng(6)
    for cfg in (dict(), dict(miss_threshold=3, beat_threshold=2)):
        jm = j_ctl.HealthMonitor(5, j_ctl.HealthConfig(**cfg))
        tm = t_ctl.HealthMonitor(5, t_ctl.HealthConfig(**cfg))
        for _ in range(200):
            beats = (rng.random(5) < 0.7).tolist()
            assert jm.observe(beats) == tm.observe(beats)
            assert jm.failed == tm.failed
        assert jm.log == tm.log and len(tm.log) > 0


def test_health_monitor_patience_both_directions():
    """``tests/test_cluster.py``'s case, on the port."""
    hm = t_ctl.HealthMonitor(3, t_ctl.HealthConfig(miss_threshold=2,
                                                   beat_threshold=2))
    assert hm.observe([True, True, True]) == ([], [])
    assert hm.observe([True, False, True]) == ([], [])
    assert hm.observe([True, False, True]) == ([1], [])
    assert hm.failed == (False, True, False)
    assert hm.observe([True, False, True]) == ([], [])
    assert hm.observe([True, True, True]) == ([], [])
    assert hm.observe([True, True, True]) == ([], [1])
    assert hm.failed == (False, False, False)
    assert hm.log == [(1, "failed"), (1, "recovered")]


def test_health_config_validates():
    with pytest.raises(ValueError):
        t_ctl.HealthConfig(miss_threshold=0)
    with pytest.raises(ValueError):
        j_ctl.HealthConfig(beat_threshold=0)
    with pytest.raises(ValueError):
        t_ctl.HealthConfig(beat_threshold=0)


# ----------------------------------------------------------------------
# Generators.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("changing_workload", dict(n_requests=6_000, n_phases=4, seed=3,
                               key_offset=7)),
    ("loop_window", dict(n_requests=4_200, capacity=300, n_phases=6,
                         window=70, p_reuse=0.8, seed=2)),
    ("mixed_apps", dict(n_requests=4_000, n_clients=8, lru_fraction=0.4,
                        seed=1)),
])
def test_generator_matches_jax(name, args):
    j = getattr(j_gen, name)(**args)
    t = getattr(t_gen, name)(**args)
    assert j.dtype == t.dtype and np.array_equal(j, t)


# ----------------------------------------------------------------------
# Four shards: the JAX cases in one 4-device subprocess.
# ----------------------------------------------------------------------

_S4_SRC = r'''
import numpy as np
S, LANES, STEPS = 4, 8, 12
TENANT_W = np.float32([[0.3, 0.7], [0.8, 0.2]])   # tenant mean votes e=0


def case_kw(name):
    kw = dict(n_buckets=64, assoc=8, capacity=256, experts=("lru", "lfu"),
              sync_period=20)
    if name == "tenants":
        kw.update(n_tenants=2, tenant_budget_blocks=(128, 128))
    return kw


def trace(gen, seed=13):
    rng = np.random.default_rng(seed)
    keys = gen.zipfian(STEPS * 4 * S * LANES, 400, 0.9, seed).reshape(
        STEPS, 4, S * LANES)
    wr = rng.random(keys.shape) < 0.3
    sz = rng.integers(1, 6, keys.shape).astype(np.uint32)
    ten = (keys % 2).astype(np.uint32)
    return keys, wr, sz, ten


SCENARIO = dict(n_buckets=64, assoc=4, capacity=96, experts=("lru", "lfu"))
SCEN_T, SCEN_WIN, SCEN_LANES = 48, 4, 4
TIMELINE = [(16, ("fail_shard", 1)), (32, ("recover_shard", 1)),
            (40, ("set_capacity", 48))]


def scenario_trace(gen):
    return gen.failover_trace(SCEN_T, SCEN_LANES, S, SCENARIO["n_buckets"],
                              hot_shard=1, hot_fraction=0.7, n_hot=12,
                              n_keys=300, seed=7).ravel()
'''

_JAX_S4_CHILD = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax
import jax.numpy as jnp
import numpy as np
from repro import elastic
from repro.core import CacheConfig
from repro.dm import Cluster
from repro.dm.sharded_cache import _dm_access_impl
from repro.workloads import gen
''' + _S4_SRC + r'''

def leaves(prefix, dm, out):
    for part in ("state", "clients", "stats"):
        tree = getattr(dm, part)
        for f in tree._fields:
            out[f"{prefix}/{part}/{f}"] = np.asarray(getattr(tree, f))


out = {}
keys, wr, sz, ten = trace(gen)
for name in ("tenants", "plain"):
    cl = Cluster.make(CacheConfig(**case_kw(name)), S, LANES, seed=5)
    fn = jax.jit(functools.partial(_dm_access_impl, cl.mesh, cl.local))
    dm = cl.dm
    for t in range(STEPS):
        dm, _ = fn(dm, keys[t], wr[t], sz[t], ten[t])
    if name == "tenants":
        w = np.broadcast_to(TENANT_W, np.asarray(dm.state.weights).shape)
        dm = dm._replace(state=dm.state._replace(weights=jax.device_put(
            jnp.asarray(w), dm.state.weights.sharding)))
        leaves("tenants/before", dm, out)
        dm2, rep = elastic.resize_memory(cl.mesh, cl.local, dm, 128,
                                         batch_per_shard=8)
        leaves("tenants/after", dm2, out)
        out["tenants/report"] = np.asarray(tuple(rep), np.int64)
    else:
        leaves("lanes/before", dm, out)
        for n_lanes in (12, 3):
            dm2, rep = elastic.resize_lanes(cl.mesh, cl.local, dm, n_lanes,
                                            seed=3)
            leaves(f"lanes/{n_lanes}", dm2, out)
            out[f"lanes/{n_lanes}/report"] = np.asarray(tuple(rep), np.int64)

res = elastic.run_scenario(
    CacheConfig(**SCENARIO), scenario_trace(gen), TIMELINE, n_shards=S,
    lanes_per_shard=SCEN_LANES, horizon=SCEN_T, window=SCEN_WIN,
    health=elastic.HealthMonitor(S), replicate_hot=8, seed=7,
    drain_batch=8)
out["scenario/json"] = np.asarray(json.dumps(dict(
    windows=res.windows, events=res.events,
    lanes=res.cluster.lanes_per_shard)))
leaves("scenario/dm", res.dm, out)
np.savez(sys.argv[1], **out)
print("JAX S=4 elastic cases: OK")
'''

_s4: dict = {}
exec(_S4_SRC, _s4)


@pytest.fixture(scope="module")
def jax_s4(tmp_path_factory):
    path = tmp_path_factory.mktemp("elastic") / "jax_s4.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_S4_CHILD, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with np.load(path) as z:
        return dict(z)


def _part(d: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in d.items() if k.startswith(prefix + "/")
            and k.count("/") == prefix.count("/") + 2}


def _carried(d: dict, prefix: str):
    """The JAX DMCache leaves under ``prefix`` as the port's DMCache."""
    tree = {part: {k.split("/")[1]: v for k, v in _part(d, prefix).items()
                   if k.startswith(part + "/")}
            for part in ("state", "clients", "stats")}
    return t_types.dm_from_numpy(tree, device="cpu")


def _local(name: str):
    return TCluster.make(t_types.CacheConfig(**_s4["case_kw"](name)),
                         _s4["S"], _s4["LANES"], seed=5, device="cpu").local


def test_four_shard_drain_with_tenant_weights_matches_jax(jax_s4):
    """Two tenants' [T, E] weights, set so the tenant mean picks the
    expert the first tenant's row would not: every shard drains in one
    batched pass, bit-equal to the JAX package's shard_map."""
    dm = _carried(jax_s4, "tenants/before")
    assert dm.state.weights.shape == (4, 2, 2)
    got, rep = t_el.resize_memory(_local("tenants"), dm, 128,
                                  batch_per_shard=8)
    assert list(rep) == jax_s4["tenants/report"].tolist()
    assert rep.drain_steps >= 2 and rep.drained_objects > 0
    _same_dm(_part(jax_s4, "tenants/after"), got, "tenant drain", exact=True)
    assert bool((got.state.bytes_cached <= 32).all())


@pytest.mark.parametrize("n_lanes", [12, 3])
def test_four_shard_resize_lanes_matches_jax(jax_s4, n_lanes):
    """Grow 8 -> 12 and shrink 8 -> 3 lanes a shard from the same state:
    the flushed ``freq``, the folded weights and every client leaf
    bit-equal."""
    dm = _carried(jax_s4, "lanes/before")
    got, rep = t_el.resize_lanes(_local("plain"), dm, n_lanes, seed=3)
    assert list(rep) == jax_s4[f"lanes/{n_lanes}/report"].tolist()
    _same_dm(_part(jax_s4, f"lanes/{n_lanes}"), got, f"lanes {n_lanes}",
             exact=True)
    assert got.clients.fc_slot.shape[0] == 4 * n_lanes


def test_four_shard_scenario_with_failover_matches_jax(jax_s4):
    """``run_scenario`` at four shards with a ``HealthMonitor``, per-window
    replica re-election and a fail / recover / shrink timeline: the same
    window dicts and events (detection two windows after the failure)
    and the final cache."""
    want = json.loads(str(jax_s4["scenario/json"]))
    res = t_el.run_scenario(
        t_types.CacheConfig(**_s4["SCENARIO"]), _s4["scenario_trace"](t_gen),
        _s4["TIMELINE"], n_shards=4, lanes_per_shard=_s4["SCEN_LANES"],
        horizon=_s4["SCEN_T"], window=_s4["SCEN_WIN"],
        health=t_el.HealthMonitor(4), replicate_hot=8, seed=7,
        drain_batch=8, device="cpu")
    got = json.loads(json.dumps(dict(windows=res.windows, events=res.events,
                                     lanes=res.cluster.lanes_per_shard)))
    for i, (jw, tw) in enumerate(zip(want["windows"], got["windows"])):
        assert jw == tw, (i, {k: (jw[k], tw[k]) for k in jw
                              if jw[k] != tw[k]})
    assert want == got
    marks = [e["t"] for e in res.events if e["event"] == "mark_failed"]
    assert marks == [16 + 2 * _s4["SCEN_WIN"]]
    _same_dm(_part(jax_s4, "scenario/dm"), res.dm, "scenario")
