"""The port's DM layer (``repro_torch.dm``: the sharded pool, its router,
``Cluster`` membership, replication and failover) against the JAX
package, on the CPU.

The JAX package runs its shards on a 4-device mesh, which needs
``--xla_force_host_platform_device_count=4`` before JAX starts: one
module-scoped fixture runs every JAX case in ONE subprocess (so JAX pays
its DM compile once) and writes an ``.npz``; each test reads its case.
The cases, at 4 shards x 8 lanes on a 64-bucket, 4-way table, 24 steps
of [4, 32] request groups (zipf keys, 30% writes, sizes 1-7):

* ``plain``: one tenant;
* ``tenants``: two tenants (``tenant_budget_blocks=(128, 128)``) at
  ``route_factor=2``, so the router drops requests over its capacity;
* ``replicas_l0``: a replica map from ``elect_replicas`` at step 4, so
  mirrors (``shadow`` ops) run, with ``l0_entries=4``;
* ``failover``: replicas as above, ``inject_failure(1)`` at step 8,
  ``mark_failed(1)`` at 11, ``recover(1, rewarm=True)`` at 16.

The JAX side steps through ``_dm_access_impl`` (jitted, with
``member=cluster.membership()``; its ``dm_execute`` raises a sharding
error on the two-tenant case under jax 0.9), the port through its own
``_dm_access_impl`` on both backends, each on its own trajectory: every
step's hits, membership and ``DMCache`` leaves must agree, integers
bit-equal, ``ext`` and ``gds_L`` within 4 ulp, the expert weights and
penalty sums (which compound every sync's ``exp``) within 16; and the
rewarm's ``ResizeReport`` equal.  ``execute(cluster, trace)`` gives the
JAX package's ``ExecResult`` fields.  In process: the membership maps,
the replica election, the rendezvous scores and the placement generators
equal the JAX package's; the capacity, budget and replica-map writes;
the item-14 paths run; a shard step's in-place writes all land in the
global table.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.dm import cluster as j_cluster
from repro.core.types import CacheConfig as JConfig
from repro.workloads import gen as j_gen
from repro_torch.core import cache as t_cache
from repro_torch.core import execute as t_execute
from repro_torch.core import types as t_types
from repro_torch.dm import Cluster
from repro_torch.dm import cluster as t_cluster
from repro_torch.dm import sharded_cache as sc
from repro_torch.workloads import gen as t_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("plain", "tenants", "replicas_l0", "failover")
# f32 leaves that compound the exp rounding of every weight sync.
_COMPOUNDED = ("weights", "local_weights", "penalty_acc")

# Shared by the JAX child and the port's side: the configs, the trace and
# the event schedule of each case.
_CASES_SRC = r'''
import numpy as np
S, LANES, G, STEPS = 4, 8, 4, 24


def case_kw(name, backend):
    kw = dict(n_buckets=64, assoc=4, capacity=96, experts=("lru", "lfu"),
              backend=backend, sync_period=20)
    if name == "tenants":
        kw.update(n_tenants=2, tenant_budget_blocks=(128, 128))
    if name == "replicas_l0":
        kw.update(l0_entries=4)
    return kw


def route_factor(name):
    return 2 if name == "tenants" else 4


def trace(gen, seed=11):
    rng = np.random.default_rng(seed)
    n = STEPS * G * S * LANES
    keys = gen.zipfian(n, 300, 0.9, seed).reshape(STEPS, G, S * LANES)
    wr = rng.random(keys.shape) < 0.3
    sz = rng.integers(1, 8, keys.shape).astype(np.uint32)
    ten = (keys % 2).astype(np.uint32)
    return keys, wr, sz, ten


def events(name, t, cl, loads, out):
    """The case's membership events before step t."""
    if name in ("replicas_l0", "failover") and t == 4:
        cl = cl.elect_replicas(loads, 12)
    if name == "failover":
        if t == 8:
            cl = cl.inject_failure(1)
        if t == 11:
            cl = cl.mark_failed(1)
        if t == 16:
            cl, rep = cl.recover(1, rewarm=True)
            out[name + "/report"] = np.asarray(tuple(rep), np.int64)
    return cl


def add_loads(gen, keys, n_buckets, loads):
    b = (gen._mix32(keys) % n_buckets).astype(np.int64)
    np.add.at(loads, b.ravel(), 1)
'''

_JAX_CHILD = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax
import numpy as np
from repro.core import CacheConfig
from repro.core.execute import execute
from repro.dm import Cluster
from repro.dm.sharded_cache import _dm_access_impl
from repro.workloads import gen
''' + _CASES_SRC + r'''

def leaves(prefix, dm, out):
    for part in ("state", "clients", "stats"):
        tree = getattr(dm, part)
        for f in tree._fields:
            out[f"{prefix}/{part}/{f}"] = np.asarray(getattr(tree, f))


out = {}
keys, wr, sz, ten = trace(gen)
for name in ("plain", "tenants", "replicas_l0", "failover"):
    cfg = CacheConfig(**case_kw(name, "reference"))
    cl = Cluster.make(cfg, S, LANES, seed=5)
    fn = jax.jit(functools.partial(_dm_access_impl, cl.mesh, cl.local,
                                   route_factor=route_factor(name)))
    leaves(name + "/init", cl.dm, out)
    loads = np.zeros(cfg.n_buckets)
    for t in range(STEPS):
        cl = events(name, t, cl, loads, out)
        m = cl.membership()
        for f in m._fields:
            out[f"{name}/{t}/member/{f}"] = np.asarray(getattr(m, f))
        dm, hits = fn(cl.dm, keys[t], wr[t], sz[t], ten[t], member=m)
        cl = cl._replace(dm=dm)
        out[f"{name}/{t}/hits"] = np.asarray(hits)
        leaves(f"{name}/{t}", dm, out)
        add_loads(gen, keys[t], cfg.n_buckets, loads)

# execute(cluster, trace): [T, S*lanes] rounds through dm_execute.
cfg = CacheConfig(**case_kw("plain", "reference"))
flat = keys.reshape(STEPS * G, S * LANES)
res = execute(Cluster.make(cfg, S, LANES, seed=5), flat,
              is_write=wr.reshape(flat.shape), sizes=sz.reshape(flat.shape))
out["execute/hits"] = np.asarray(res.hits)
out["execute/ops"] = np.asarray(res.ops)
out["execute/hit_rate"] = np.asarray(res.hit_rate)
out["execute/weights"] = np.asarray(res.weights)
leaves("execute", res.cache.dm, out)
for f in res.stats._fields:
    out["execute/sum/" + f] = np.asarray(getattr(res.stats, f))
np.savez(sys.argv[1], **out)
print("JAX DM cases: OK")
'''

_ns: dict = {}
exec(_CASES_SRC, _ns)
S, LANES, STEPS = _ns["S"], _ns["LANES"], _ns["STEPS"]


@pytest.fixture(scope="module")
def jax_dm(tmp_path_factory):
    path = tmp_path_factory.mktemp("dm") / "jax_dm.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with np.load(path) as z:
        return dict(z)


def _t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _assert_dm(got, want: dict, prefix: str):
    for part in ("state", "clients", "stats"):
        for f, g in got[part].items():
            w = want[f"{prefix}/{part}/{f}"]
            assert g.shape == w.shape, (prefix, part, f, g.shape, w.shape)
            if w.dtype.kind == "f":
                np.testing.assert_array_max_ulp(
                    g, w, maxulp=16 if f in _COMPOUNDED else 4)
            else:
                assert np.array_equal(g.astype(np.int64),
                                      w.astype(np.int64)), (prefix, part, f)


def _jax_tree(want: dict, prefix: str) -> dict:
    """The npz's leaves under ``prefix`` as {state, clients, stats}."""
    out = {"state": {}, "clients": {}, "stats": {}}
    for k, v in want.items():
        depth = prefix.count("/") + 2
        if k.startswith(prefix + "/") and k.count("/") == depth:
            part, f = k.split("/")[-2:]
            if part in out:
                out[part][f] = v
    return out


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("case", CASES)
def test_dm_steps_match_jax(jax_dm, case, backend):
    keys, wr, sz, ten = _ns["trace"](t_gen)
    cfg = t_types.CacheConfig(**_ns["case_kw"](case, backend))
    cl = Cluster.make(cfg, S, LANES, seed=5, device="cpu")
    _assert_dm(t_types.dm_to_numpy(cl.dm), jax_dm, case + "/init")
    # The run starts from the JAX package's cluster, carried across.
    cl = cl._replace(dm=t_types.dm_from_numpy(
        _jax_tree(jax_dm, case + "/init"), "cpu"))
    loads = np.zeros(cfg.n_buckets)
    report = {}
    for t in range(STEPS):
        cl = _ns["events"](case, t, cl, loads, report)
        m = cl.membership()
        for f in m._fields:
            assert np.array_equal(getattr(m, f).numpy(),
                                  jax_dm[f"{case}/{t}/member/{f}"]), (t, f)
        dm, hits = sc._dm_access_impl(
            cl.local, cl.dm, _t64(keys[t]), torch.as_tensor(wr[t]),
            _t64(sz[t]), _t64(ten[t]), route_factor=_ns["route_factor"](case),
            member=m)
        cl = cl._replace(dm=dm)
        assert np.array_equal(hits.numpy(), jax_dm[f"{case}/{t}/hits"]), t
        _assert_dm(t_types.dm_to_numpy(dm), jax_dm, f"{case}/{t}")
        _ns["add_loads"](t_gen, keys[t], cfg.n_buckets, loads)
    st = cl.stats
    assert int(st.evictions) > 0
    assert int(st.gets + st.sets + st.route_drops) == int((keys != 0).sum())
    if case == "tenants":
        assert int(st.route_drops) > 0
    if case in ("replicas_l0", "failover"):
        assert int(st.replica_writes) > 0
    if case == "replicas_l0":
        assert int(st.l0_hits) > 0
    if case == "failover":
        assert np.array_equal(report["failover/report"],
                              jax_dm["failover/report"])
        assert report["failover/report"][1] > 0       # objects moved


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_execute_cluster_matches_jax(jax_dm, backend):
    keys, wr, sz, _ = _ns["trace"](t_gen)
    cfg = t_types.CacheConfig(**_ns["case_kw"]("plain", backend))
    flat = keys.reshape(-1, S * LANES)
    res = t_execute(Cluster.make(cfg, S, LANES, seed=5, device="cpu"), flat,
                    is_write=wr.reshape(flat.shape),
                    sizes=sz.reshape(flat.shape))
    assert np.array_equal(res.hits, jax_dm["execute/hits"])
    assert np.array_equal(res.ops, jax_dm["execute/ops"])
    assert res.weights.shape == jax_dm["execute/weights"].shape
    assert res.hit_rate == float(jax_dm["execute/hit_rate"])
    assert res.cfg == cfg
    for f in res.stats._fields:
        assert int(getattr(res.stats, f)) == int(jax_dm["execute/sum/" + f]), f
    _assert_dm(t_types.dm_to_numpy(res.cache.dm), jax_dm, "execute")
    assert res.state is res.cache.dm.state
    assert res.clients is res.cache.dm.clients


def _j_cluster(cfg_kw, routed=(True,) * 4, alive=(True,) * 4, replicas=None):
    """A JAX Cluster handle for its host-side membership code (no mesh or
    state: membership() and elect_replicas() read neither)."""
    cfg = JConfig(**cfg_kw)
    local = JConfig(**dict(cfg_kw, n_buckets=cfg.n_buckets // 4,
                           capacity=cfg.capacity // 4))
    rep = (np.full((cfg.n_buckets,), 4, np.int32) if replicas is None
           else np.asarray(replicas, np.int32))
    return j_cluster.Cluster(mesh=None, cfg=cfg, local=local, dm=None,
                             n_shards=4, lanes_per_shard=8, alive=alive,
                             routed=routed, replicas=rep, seed=0)


@pytest.mark.parametrize("routed", [(True,) * 4, (True, False, True, True),
                                    (False, False, True, True)])
def test_membership_and_election_match_jax(routed):
    kw = dict(n_buckets=256, assoc=4, capacity=256)
    loads = np.random.default_rng(3).zipf(1.3, 256).astype(np.float64)
    loads[::7] = 0.0
    t = Cluster.make(t_types.CacheConfig(**kw), 4, 8, device="cpu")
    j = _j_cluster(kw)
    for n_hot in (0, 5, 40, 300):
        je = j.elect_replicas(loads, n_hot)
        te = t.elect_replicas(loads, n_hot)
        assert np.array_equal(te.replica_map(), je.replica_map()), n_hot
        je = je._replace(routed=routed, alive=routed)
        te = te._replace(routed=routed, alive=routed)
        jm, tm = je.membership(), te.membership()
        for f in jm._fields:
            assert np.array_equal(getattr(tm, f).numpy(),
                                  np.asarray(getattr(jm, f))), (n_hot, f)
        # Elected while a shard is marked failed: never onto it.
        assert np.array_equal(te.elect_replicas(loads, n_hot).replica_map(),
                              je.elect_replicas(loads, n_hot).replica_map())


def test_rendezvous_scores_match_jax():
    for nb, ns in ((64, 4), (1000, 8), (7, 3)):
        assert np.array_equal(t_cluster._rendezvous_scores(nb, ns),
                              j_cluster._rendezvous_scores(nb, ns))


def test_placement_generators_match_jax():
    keys = np.random.default_rng(0).integers(1, 2**32, 5000,
                                             dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(t_gen._mix32(keys), j_gen._mix32(keys))
    for ns, nb in ((4, 64), (8, 1024)):
        assert np.array_equal(t_gen.shard_of(keys, ns, nb),
                              j_gen.shard_of(keys, ns, nb))
        assert np.array_equal(t_gen.keys_owned_by(2, 50, ns, nb, seed=7),
                              j_gen.keys_owned_by(2, 50, ns, nb, seed=7))
    kw = dict(hot_shard=1, hot_fraction=0.7, n_hot=48, n_keys=3000, seed=7)
    assert np.array_equal(t_gen.failover_trace(32, 8, 4, 1024, **kw),
                          j_gen.failover_trace(32, 8, 4, 1024, **kw))


def test_item14_paths_raise():
    """The item-14 paths, which raised until the elastic runtime was
    ported, run: ``drain_to`` and ``with_lanes`` (both spellings) give
    what the ``resize`` functions give on ``(local, dm)``, the drain
    leaves every shard within its budget, and the resized cluster
    serves."""
    from repro_torch import elastic
    cl = Cluster.make(t_types.CacheConfig(n_buckets=64, assoc=4,
                                          capacity=96), 4, 8, device="cpu")
    keys = _t64(t_gen.zipfian(16 * S * LANES, 300, 0.9, 3)).view(16, -1)
    cl, _ = cl.execute(keys)
    assert bool((cl.dm.state.bytes_cached > 12).any())
    shrunk, report = cl.drain_to(48)
    dm, want = elastic.resize_memory(cl.local, cl.dm, 48)
    assert report == want and report.drain_steps >= 1
    assert report.migration_bytes == 0 and report.drained_objects > 0
    assert all(torch.equal(a, b) for a, b in zip(shrunk.dm.state, dm.state))
    assert bool((shrunk.dm.state.bytes_cached <= 12).all())
    assert elastic.enforce_budget(cl.local, shrunk.dm)[1] == 0
    dm, want = elastic.resize_lanes(cl.local, cl.dm, 4, seed=cl.seed + 1)
    for narrow, report in (cl.with_lanes(4), t_cluster.with_lanes(cl, 4)):
        assert report == want == (0, 0, 0, 0)
        assert narrow.lanes_per_shard == 4
        assert all(torch.equal(a, b)
                   for a, b in zip(narrow.dm.clients, dm.clients))
        _, hits = narrow.execute(keys[:, :S * 4])
        assert hits.shape == (16, S * 4)


def test_capacity_budget_and_replica_writes():
    """The handle's scalar writes (one a shard, no data movement), their
    free-function spellings, and the replica map's validation."""
    cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=96,
                              n_tenants=3, tenant_budget_blocks=(40, 30, 26))
    cl = Cluster.make(cfg, 4, 8, device="cpu")
    assert cl.dm.state.tenant_budget.numpy().tolist() == \
        t_types.split_tenant_budgets((40, 30, 26), 4).tolist()
    for c in (cl.with_capacity(200), t_cluster.with_capacity(cl, 200)):
        assert c.dm.state.capacity_blocks.tolist() == [50] * 4
        assert c.dm.state.key is cl.dm.state.key
    for c in (cl.with_tenant_budgets((9, 8, 7)),
              t_cluster.with_tenant_budgets(cl, (9, 8, 7))):
        assert c.dm.state.tenant_budget.sum(dim=0).tolist() == [9, 8, 7]
    rep = np.full(64, 4, np.int32)
    rep[3] = 2
    c = cl.with_replicas(rep)
    assert np.array_equal(t_cluster.replica_map(c), rep)
    assert int(c.membership().replica[3]) == 2
    assert int(t_cluster.mark_failed(c, 2).membership().replica[3]) == 4
    for bad in (np.full(63, 4), np.full(64, 5), np.full(64, -1)):
        with pytest.raises(ValueError):
            cl.with_replicas(bad)
    with pytest.raises(ValueError):
        cl.inject_failure(4)
    # The round trip of the numpy conversion.
    again = t_types.dm_from_numpy(t_types.dm_to_numpy(cl.dm), "cpu")
    for a, b in zip(t_cache._leaves(again), t_cache._leaves(cl.dm)):
        assert torch.equal(a, b)


def test_execute_cluster_refuses_a_plan():
    cl = Cluster.make(t_types.CacheConfig(n_buckets=64, assoc=4,
                                          capacity=96), 4, 8, device="cpu")
    with pytest.raises(ValueError, match="plan=None"):
        t_execute(cl, np.ones((2, 32), np.uint32), plan="strict")


def test_deprecated_shims_warn_and_match():
    cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=96)
    cl = Cluster.make(cfg, 4, 8, device="cpu")
    with pytest.warns(DeprecationWarning):
        dev, dm, local = sc.dm_make(cfg, 4, 8, device="cpu")
    assert local == cl.local and dev == cl.device
    for a, b in zip(t_cache._leaves(dm), t_cache._leaves(cl.dm)):
        assert torch.equal(a, b)
    keys = _t64(np.arange(1, 33)[None] * 7)
    with pytest.warns(DeprecationWarning):
        dm1, h1 = sc.dm_access(cl.local, cl.dm, keys)
    dm2, h2 = sc._dm_access_impl(cl.local, cl.dm, keys)
    assert torch.equal(h1, h2)
    with pytest.warns(DeprecationWarning):
        dm3 = sc.dm_set_capacity(cl.dm, 64, 4)
    assert dm3.state.capacity_blocks.tolist() == [16] * 4
    assert cl.with_capacity(64).dm.state.capacity_blocks.tolist() == [16] * 4


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("l0", [0, 4])
def test_every_shard_write_lands_in_the_global_table(backend, l0):
    """Each shard's step, run on views of its slice inside the DM step,
    must leave the global table exactly as the same step run on its own
    copy of that shard leaves the copy: a write the step rebound instead
    of writing in place would be lost from the global table."""
    cfg = t_types.CacheConfig(n_buckets=64, assoc=4, capacity=96,
                              n_tenants=2, tenant_budget_blocks=(64, 64),
                              l0_entries=l0, backend=backend)
    cl = Cluster.make(cfg, 4, 8, device="cpu")
    keys, wr, sz, ten = _ns["trace"](t_gen)
    for t in range(3):                      # warm: fill every shard
        cl = cl._replace(dm=sc._dm_access_impl(
            cl.local, cl.dm, _t64(keys[t]), torch.as_tensor(wr[t]),
            _t64(sz[t]), _t64(ten[t]))[0])
    dm = cl.dm
    G, lanes, q = 4, 8, sc._route_capacity(8, 4, 4)
    split = lambda x: _t64(x).reshape(1, G, 4, lanes)
    member = cl.membership()
    rt = sc._route(4, lanes, q, cfg.n_buckets, split(keys[3]),
                   split(wr[3]).bool(), split(np.clip(sz[3], 1, 254)),
                   split(ten[3]), member)
    recv, _, _ = sc._exchange(rt, member.serving)
    new, _ = sc._dm_access_impl(cl.local, dm, _t64(keys[3]),
                                torch.as_tensor(wr[3]), _t64(sz[3]),
                                _t64(ten[3]))
    ls, lb = cl.local.n_slots, cl.local.n_buckets
    changed = 0
    for k in range(4):
        own = sc._shard_state(dm.state, k, ls, lb)
        own = own._replace(**{f: getattr(own, f).clone() for f in own._fields})
        lanes_k = sc._shard_lanes(dm.clients, k, lanes)
        st, _, _, _ = t_cache.access_group_(
            cl.local, own, sc._pad_clients(lanes_k, 4 * q),
            t_types.OpStats(*[f[k] for f in dm.stats]),
            recv.keys[0, k], is_write=recv.is_write[0, k],
            obj_size=recv.size[0, k], tenant=recv.tenant[0, k],
            shadow=recv.shadow[0, k])
        got = sc._shard_state(new.state, k, ls, lb)
        for f in t_cache.written_columns(cl.local):
            assert torch.equal(getattr(got, f), getattr(st, f)), (k, f)
            changed += int((getattr(st, f) != getattr(
                sc._shard_state(dm.state, k, ls, lb), f)).any())
        for f in ("n_cached", "bytes_cached", "hist_ctr", "clock",
                  "tenant_bytes"):
            assert torch.equal(getattr(got, f), getattr(st, f)), (k, f)
    assert changed >= 4 * 3        # every shard moved several columns
