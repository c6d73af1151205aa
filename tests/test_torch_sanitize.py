"""The port's invariant sanitizer (``repro_torch.analysis.sanitize``)
against the JAX package's, on the CPU.

The mutation tests of ``tests/test_analysis.py``: a seeded state (the
JAX step's, carried across with ``state_from_numpy``) is corrupted the
same way on both sides, and each SAN rule must raise in the port with
the message of the JAX package's first failed check.  The corruptions
that survive a step (``n_cached``, ``tenant_bytes`` and the lanes'
weights move incrementally; a duplicate key or a future timestamp in a
bucket the step leaves alone) must also raise from a ``_scan``-driven
segment, where the step's checks fold into the carried word and are read
once at the end.  ``checked`` defers every failure to its exit.  SAN006:
``check_plan`` gives the JAX package's findings on seeded plans, and the
planners' ``validate=True`` passes on their own output.  A clean seeded
trace with ``sanitize=True`` leaves state, stats and hits bit-equal to
``sanitize=False`` on both backends, and the armed step raises on a
corrupted carry (SAN003).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as j_san
from repro.core import types as j_types
from repro.core.cache import access_group as j_access_group
from repro.workloads import plan as j_plan
from repro_torch.analysis import sanitize as t_san
from repro_torch.core import cache as t_cache
from repro_torch.core import types as t_types
from repro_torch.core.execute import execute as t_execute
from repro_torch.core.execute import make as t_make
from repro_torch.workloads import plan as t_plan


def _kw(n_tenants=1, backend="reference"):
    kw = dict(n_buckets=64, assoc=4, capacity=64, hist_len=64,
              backend=backend, n_tenants=n_tenants)
    if n_tenants > 1:
        kw["tenant_budget_blocks"] = tuple([32] * n_tenants)
    return kw


def _seeded(n_tenants=1):
    """``tests/test_analysis.py``'s seeded state, from the JAX step, as
    numpy dicts (state, clients) and the two configs."""
    jcfg = j_types.CacheConfig(**_kw(n_tenants))
    st, cl, sa = (j_types.init_cache(jcfg), j_types.init_clients(jcfg, 4),
                  j_types.init_stats())
    keys = (jnp.arange(1, 33, dtype=jnp.uint32).reshape(8, 4) % 7) + 1
    ten = (keys % n_tenants).astype(jnp.uint32) if n_tenants > 1 else None
    st, cl, sa, _ = j_access_group(jcfg, st, cl, sa, keys,
                                   is_write=jnp.ones((8, 4), bool), tenant=ten)
    host = lambda tree: {f: np.asarray(getattr(tree, f)) for f in tree._fields}
    return jcfg, t_types.CacheConfig(**_kw(n_tenants)), host(st), host(cl)


def _j_tree(cls, d):
    return cls(**{f: jnp.asarray(v) for f, v in d.items()})


def _t_state(d):
    return t_types.state_from_numpy(d, "cpu")


def _bump(d, f, fn):
    d = dict(d)
    d[f] = fn(d[f].copy())
    return d


def _set(**sets):
    def fn(d):
        d = dict(d)
        for f, items in sets.items():
            a = d[f].copy()
            for i, v in items:
                a[i] = v
            d[f] = a
        return d
    return fn


# (rule, tenants, which check, the corruption of the state or clients)
MUTATIONS = {
    "san001_bytes": ("SAN001", 1, "state",
                     lambda d: _bump(d, "bytes_cached", lambda a: a + 5)),
    "san001_count": ("SAN001", 1, "state",
                     lambda d: _bump(d, "n_cached", lambda a: a + 2)),
    "san002_column_sum": ("SAN002", 2, "state",
                          lambda d: _bump(d, "tenant_bytes",
                                          lambda a: a + np.array([3, 0]))),
    "san002_overshoot": ("SAN002", 2, "step",
                         lambda d: dict(d, tenant_bytes=d["tenant_budget"] + 1,
                                        bytes_cached=np.int32(
                                            (d["tenant_budget"] + 1).sum()))),
    "san003_duplicate": ("SAN003", 1, "state",
                         _set(key=[(0, 7), (1, 7)], size=[(0, 1), (1, 1)])),
    "san004_weights": ("SAN004", 1, "state",
                       lambda d: _bump(d, "weights", lambda a: a * 0 + 2.0)),
    "san004_local": ("SAN004", 1, "clients",
                     lambda d: _bump(d, "local_weights", lambda a: a - 1.0)),
    "san005_future": ("SAN005", 1, "state",
                      lambda d: _set(size=[(0, 1)], last_ts=[
                          (0, int(d["clock"]) + 5)])(d)),
    "san005_clock_back": ("SAN005", 1, "step",
                          lambda d: _bump(d, "clock", lambda a: a - 1)),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_each_rule_fires_with_the_jax_message(name):
    rule, nt, which, mutate = MUTATIONS[name]
    jcfg, tcfg, st, cl = _seeded(nt)
    if which == "clients":
        bad_cl = mutate(cl)
        j_call = lambda: j_san.check_clients(
            jcfg, _j_tree(j_types.ClientState, bad_cl), rules=[rule])
        t_call = lambda: t_san.check_clients(
            tcfg, t_types.clients_from_numpy(bad_cl, "cpu"), rules=[rule])
    elif which == "step":
        bad = mutate(st)
        j_call = lambda: j_san.check_step(
            jcfg, _j_tree(j_types.CacheState, st),
            _j_tree(j_types.CacheState, bad), rules=[rule])
        t_call = lambda: t_san.check_step(tcfg, _t_state(st), _t_state(bad),
                                          rules=[rule])
    else:
        bad = mutate(st)
        j_call = lambda: j_san.check_state(
            jcfg, _j_tree(j_types.CacheState, bad), rules=[rule])
        t_call = lambda: t_san.check_state(tcfg, _t_state(bad), rules=[rule])
    with pytest.raises(Exception, match=rule) as j_err:
        j_call()
    with pytest.raises(t_san.SanitizerError, match=rule) as t_err:
        t_call()
    assert str(t_err.value) in str(j_err.value)
    # Deferred inside `checked`: nothing raises until the wrapped call
    # returns.
    seen = []
    wrapped = t_san.checked(lambda: (t_call(), seen.append(1)))
    with pytest.raises(t_san.SanitizerError, match=rule):
        wrapped()
    assert seen == [1]


def test_clean_state_passes_and_shrunk_budget_is_legal():
    _, tcfg, st, cl = _seeded(2)
    t_san.check_state(tcfg, _t_state(st))
    t_san.check_clients(tcfg, t_types.clients_from_numpy(cl, "cpu"))
    shrunk = _t_state(dict(st, tenant_budget=np.zeros_like(
        st["tenant_budget"])))
    t_san.check_step(tcfg, shrunk, shrunk, rules=["SAN002"])


# Corruptions a step carries on: (rule, tenants, corruption); the trace
# then touches only keys of other buckets than slots 0-1's.
SURVIVING = {
    "SAN001": (1, lambda d: _bump(d, "n_cached", lambda a: a + 2), "state"),
    "SAN002": (2, lambda d: _bump(d, "tenant_bytes",
                                  lambda a: a + np.array([3, 0])), "state"),
    "SAN003": (1, lambda d: dict(
        _set(key=[(0, 999), (1, 999)], size=[(0, 1), (1, 1)])(d),
        bytes_cached=d["bytes_cached"] + 2, n_cached=d["n_cached"] + 2),
        "state"),
    "SAN004": (1, lambda d: _bump(d, "local_weights", lambda a: a - 1.0),
               "clients"),
    "SAN005": (1, lambda d: dict(
        _set(size=[(0, 1)], last_ts=[(0, int(d["clock"]) + 50)])(d),
        bytes_cached=d["bytes_cached"] + 1, n_cached=d["n_cached"] + 1),
        "state"),
}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("rule", sorted(SURVIVING))
def test_each_rule_fires_at_the_end_of_a_scan_segment(rule, grouped):
    nt, mutate, which = SURVIVING[rule]
    _, tcfg, st, cl = _seeded(nt)
    scfg = dataclasses.replace(tcfg, sanitize=True)
    if which == "clients":
        cl = mutate(cl)
    else:
        st = mutate(st)
    state = _t_state(st)
    clients = t_types.clients_from_numpy(cl, "cpu")
    # Keys of buckets other than bucket 0's (slots 0-1).
    keys = torch.arange(100, 124, dtype=torch.int64)
    keys = keys[(t_cache.bucket_of(t_cache.hash_key(keys), 64) != 0)][:16]
    keys = keys.reshape(4, 4)
    with pytest.raises(t_san.SanitizerError, match=rule):
        if grouped:
            t_cache._run_trace_grouped_impl(scfg, state, clients,
                                            keys.reshape(2, 2, 4))
        else:
            t_cache._run_trace_impl(scfg, state, clients, keys)


def test_sanitized_step_catches_corrupt_carry():
    """``tests/test_analysis.py``'s case on the port's eager step."""
    _, tcfg, st, cl = _seeded(1)
    scfg = dataclasses.replace(tcfg, sanitize=True)
    bad = _t_state(SURVIVING["SAN003"][1](st))
    with pytest.raises(t_san.SanitizerError, match="SAN003"):
        t_cache.access_group(scfg, bad, t_types.clients_from_numpy(cl, "cpu"),
                             t_types.init_stats("cpu"),
                             torch.full((1, 4), 3, dtype=torch.int64))


def _drift_trace():
    rng = np.random.default_rng(4)
    keys = (rng.zipf(1.2, (60, 4)) % 90 + 1).astype(np.uint32)
    return keys, rng.random((60, 4)) < 0.3, (keys % 2).astype(np.uint32)


def _first_failing_step(step, n):
    for t in range(n):
        try:
            step(t)
        except Exception as e:              # noqa: BLE001 (JAX's or ours)
            return t, str(e)
    return None, ""


def test_lane_weight_drift_fires_san004_where_jax_does():
    """Between syncs a lane's local weights are scaled by its penalties
    and not renormalized, so with regrets and ``sync_period`` 100 they
    leave the simplex: the JAX package's sanitizer fires SAN004 there,
    and the port's fires at the same step."""
    keys, wr, ten = _drift_trace()
    kw = dict(_kw(2), sanitize=True)
    jcfg, tcfg = j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)
    j = [j_types.init_cache(jcfg), j_types.init_clients(jcfg, 4),
         j_types.init_stats()]
    t = list(t_cache.make_cache(tcfg, 4, device="cpu"))

    def j_step(i):
        j[:3] = j_access_group(jcfg, *j, jnp.asarray(keys[i:i + 1]),
                               is_write=jnp.asarray(wr[i:i + 1]),
                               tenant=jnp.asarray(ten[i:i + 1]))[:3]

    def t_step(i):
        t[:3] = t_cache.access_group(
            tcfg, *t, torch.as_tensor(keys[i:i + 1].astype(np.int64)),
            is_write=torch.as_tensor(wr[i:i + 1]),
            tenant=torch.as_tensor(ten[i:i + 1].astype(np.int64)))[:3]

    j_at, j_msg = _first_failing_step(j_step, 60)
    t_at, t_msg = _first_failing_step(t_step, 60)
    assert j_at is not None and (t_at, t_msg in j_msg) == (j_at, True)
    assert t_msg.startswith("SAN004")


@pytest.mark.parametrize("plan", [None, "strict"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_sanitized_trace_is_bit_equal(backend, plan):
    """A clean trace: ``sync_period=1`` syncs every lane with a regret in
    the step it has one, so the lanes' weights stay on the simplex."""
    cfg = t_types.CacheConfig(**dict(_kw(2, backend), sync_period=1))
    scfg = dataclasses.replace(cfg, sanitize=True)
    keys, wr, ten = _drift_trace()
    runs = [t_execute(t_make(c, 4, 0, device="cpu"), keys, plan=plan,
                      is_write=wr, tenants=ten) for c in (cfg, scfg)]
    assert int(runs[0].stats.evictions) > 0
    assert int(runs[0].stats.regrets) > 0
    assert np.array_equal(runs[0].hits, runs[1].hits)
    for part in ("state", "clients", "stats"):
        for a, b in zip(getattr(runs[0], part), getattr(runs[1], part)):
            assert torch.equal(a, b), part


def _plan(scope, keys, wr=None, src=None):
    keys = np.asarray(keys, np.uint32)
    wr = np.zeros(keys.shape, bool) if wr is None else wr
    src = np.zeros(keys.shape, np.int32) if src is None else src
    return (j_plan.GroupPlan(keys, wr, np.ones_like(keys), src,
                             batch=keys.shape[1], scope=scope),
            t_plan.GroupPlan(keys, wr, np.ones_like(keys), src,
                             batch=keys.shape[1], scope=scope))


@pytest.mark.parametrize("seed", range(6))
def test_check_plan_gives_the_jax_findings(seed):
    rng = np.random.default_rng(seed)
    shape = (3, 4, 5)
    keys = rng.integers(0, 12, shape).astype(np.uint32)
    wr = rng.random(shape) < 0.4
    src = rng.integers(-1, 30, shape).astype(np.int32)
    for scope in ("strict", "lane"):
        jp, tp = _plan(scope, keys, wr, src)
        jf = j_san.check_plan(jp, 16)
        tf = t_san.check_plan(tp, 16)
        assert [tuple(f) for f in tf] == [tuple(f) for f in jf]
        assert tf, "a seeded random plan has conflicts"
        with pytest.raises(ValueError, match="SAN006"):
            t_san.assert_plan_ok(tp, 16)


def test_plan_rules():
    k = np.full((1, 2, 1), 7, np.uint32)
    _, strict = _plan("strict", k)
    assert t_san.check_plan(strict, 64)
    w = np.zeros_like(k, bool)
    w[0, 1, 0] = True
    assert t_san.check_plan(_plan("lane", k, w)[1], 64)
    assert not t_san.check_plan(_plan("lane", k)[1], 64)   # read-read
    k2 = np.full((2, 1, 1), 7, np.uint32)
    order = _plan("strict", k2, src=np.array([[[5]], [[2]]], np.int32))[1]
    assert {f.rule for f in t_san.check_plan(order, 64)} == {"SAN006"}


def test_planner_output_validates():
    rng = np.random.RandomState(1)
    keys = (rng.zipf(1.3, size=(40, 8)) % 61 + 1).astype(np.uint32)
    wr = rng.rand(40, 8) < 0.3
    for scope in ("strict", "lane"):
        plan = t_plan.plan_groups(keys, 64, 4, scope=scope, is_write=wr,
                                  validate=True)
        assert t_san.check_plan(plan, 64) == []
    plan = t_plan.pack_rows(keys, 64, 4, is_write=wr, validate=True)
    assert t_san.check_plan(plan, 64) == []
    sched = t_plan.plan_adaptive(keys, 64, 8, is_write=wr, validate=True,
                                 min_gain=0.0)
    assert any(s.plan is not None for s in sched.segments)
