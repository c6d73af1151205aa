"""The port's baselines (``repro_torch.baselines``), the facade's residue
in ``repro_torch.core`` and the port's examples, against the JAX
package, on the CPU.

* ``simulate_policy`` (lru, mru, fifo, lfu) and ``PyDitto`` on seeded
  traces of ``repro_torch.workloads`` generators: the same hit rates,
  and PyDitto's expert weights bit-equal (both are the same host Python
  and numpy).
* The four system models on a grid of inputs: equal numbers, and
  ``RedisModel.timeline``'s arrays equal.
* ``run_trace`` and ``run_trace_grouped`` warn ``DeprecationWarning`` as
  the JAX package's do and equal ``execute`` bit for bit (``plan=None``,
  and the same precomputed plan); ``loc_of`` is a positive line count
  for every algorithm; ``repro_torch.core.__all__`` covers
  ``repro.core.__all__`` and ``repro_torch.baselines.__all__`` equals
  ``repro.baselines.__all__``.
* The five ``examples/torch_*.py`` exist and import nothing of ``jax``
  or ``repro`` (an AST check: the port's eager CPU path is too slow to
  run them whole here; the card runs them).
"""

import ast
import itertools
import pathlib
import types

import numpy as np
import pytest
import torch

import repro.baselines as j_base
import repro.core as j_core
import repro_torch.baselines as t_base
import repro_torch.core as t_core
from repro.baselines import systems as j_sys
from repro_torch.baselines import systems as t_sys
from repro_torch.core import CacheConfig, execute, make
from repro_torch.core import cache as t_cache
from repro_torch.workloads import gen, plan

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "multi_tenant_cache", "dm_elastic_cache",
            "serve_with_prefix_cache", "train_lm")
CAP = 256


def _traces():
    return {
        "zipf": gen.zipfian(12_000, 2_000, seed=1),
        "lru": gen.lru_friendly(12_000, 3_000, window=256, seed=2),
        "lfu": gen.lfu_friendly(12_000, seed=3),
        "loop": gen.loop_window(12_000, CAP, seed=4),
    }


TRACES = _traces()


@pytest.mark.parametrize("policy", ["lru", "mru", "fifo", "lfu"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_simulate_policy_equals_jax(policy, trace):
    keys = TRACES[trace]
    got = t_base.simulate_policy(keys, CAP, policy)
    assert got == j_base.simulate_policy(keys, CAP, policy)
    assert 0.0 < got < 1.0


def test_simulate_policy_refuses_an_unknown_policy():
    with pytest.raises(ValueError):
        t_base.simulate_policy(TRACES["zipf"], CAP, "random")


@pytest.mark.parametrize("experts", [("lru",), ("lfu",), ("lru", "lfu"),
                                     ("lru", "lfu", "fifo", "mru")])
@pytest.mark.parametrize("trace", ["zipf", "loop"])
def test_pyditto_equals_jax(experts, trace):
    keys = TRACES[trace]
    kw = dict(n_samples=5, experts=experts, seed=7)
    t, j = t_base.PyDitto(CAP, **kw), j_base.PyDitto(CAP, **kw)
    assert t.run(keys) == j.run(keys)
    np.testing.assert_array_equal(t.w.view(np.uint64), j.w.view(np.uint64))
    assert (t.hits, t.ops, t.hist_ctr) == (j.hits, j.ops, j.hist_ctr)
    assert t.history == j.history and t.md == j.md


def _stats(gets, sets, per_op_msgs, rd_bytes, wr_bytes):
    n = gets + sets
    return types.SimpleNamespace(
        gets=gets, sets=sets, rdma_read=int(n * per_op_msgs * 0.6),
        rdma_write=int(n * per_op_msgs * 0.2), rdma_cas=sets, rdma_faa=gets,
        rpc=0, rdma_read_bytes=rd_bytes, rdma_write_bytes=wr_bytes)


@pytest.mark.parametrize("n_clients", [1, 8, 64, 512])
def test_system_models_equal_jax(n_clients):
    fracs, hits = (0.0, 0.05, 0.5, 1.0), (1.0, 0.9, 0.5)
    stats = [_stats(1000, 0, 3.1, 400_000, 0),
             _stats(500, 500, 4.0, 4_000_000, 2_000_000),
             _stats(10, 5, 2.0, -1, 10)]
    for st, f, h in itertools.product(stats, fracs, hits):
        t, j = t_sys.DittoModel(), j_sys.DittoModel()
        assert t.throughput(n_clients, st, f, h) == j.throughput(
            n_clients, st, f, h)
        assert t.bytes_per_op(st) == j.bytes_per_op(st)
        for cores in (1, 4):
            assert t_sys.CliqueMapModel(mn_cores=cores).throughput(
                n_clients, f, h) == j_sys.CliqueMapModel(
                    mn_cores=cores).throughput(n_clients, f, h)
        for shards, backoff in ((32, 5e-6), (8, 1e-6)):
            assert t_sys.ShardLRUModel(n_shards=shards,
                                       backoff=backoff).throughput(
                n_clients, f) == j_sys.ShardLRUModel(
                    n_shards=shards, backoff=backoff).throughput(n_clients, f)


def test_redis_model_equals_jax():
    t, j = t_sys.RedisModel(), j_sys.RedisModel(n_keys=10_000_000)
    for n in (1, 2, 8, 16, 32, 48, 64, 128):
        assert t.steady_throughput(n) == j.steady_throughput(n)
    for frac in (0.0, 0.25, 0.5, 1.0):
        assert t.migration_seconds(frac) == j.migration_seconds(frac)
        assert t.migration_bytes(frac) == j.migration_bytes(frac)
    for events, horizon, dt in (([(0, 32), (60, 64), (900, 32)], 1500, 1.0),
                                ([(0, 16), (10, 8)], 200, 0.5)):
        for a, b in zip(t.timeline(events, horizon, dt),
                        j.timeline(events, horizon, dt)):
            np.testing.assert_array_equal(a, b)
    assert t_sys.CLUSTER == t_sys.Cluster()


# ---------------------------------------------------------------------------
# The facade's residue.
# ---------------------------------------------------------------------------

def _cache_and_trace(seed):
    cfg = CacheConfig(n_buckets=32, assoc=8, capacity=128,
                      experts=("lru", "lfu"))
    keys = gen.interleave(gen.zipfian(800, 1_000, seed=seed), 4)
    return make(cfg, 4, seed=seed, device="cpu"), keys


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same_cache(a, b):
    for x, y in zip(list(a.state) + list(a.clients),
                    list(b.state) + list(b.clients)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_run_trace_warns_and_equals_execute(seed):
    cache, keys = _cache_and_trace(seed)
    with pytest.warns(DeprecationWarning, match="execute"):
        tr = t_core.run_trace(cache.cfg, cache.state, cache.clients,
                              _t64(keys))
    res = execute(cache, keys, plan=None)
    assert int(res.stats.evictions) > 0
    np.testing.assert_array_equal(tr.hits.numpy(), res.hits)
    np.testing.assert_array_equal(tr.ops.numpy(), res.ops)
    np.testing.assert_array_equal(tr.weights.numpy(), res.weights)
    _same_cache(tr, res)


def test_run_trace_grouped_warns_and_equals_execute():
    cache, keys = _cache_and_trace(2)
    gp = plan.pack_rows(keys, cache.cfg.n_buckets, 4)
    with pytest.warns(DeprecationWarning, match="execute"):
        tr = t_cache.run_trace_grouped(cache.cfg, cache.state, cache.clients,
                                       _t64(gp.keys))
    res = execute(cache, keys, plan=gp)
    np.testing.assert_array_equal(tr.hits.numpy(), res.hits)
    _same_cache(tr, res)


@pytest.mark.parametrize("name", list(j_core.ALL_ALGORITHMS))
def test_loc_of_is_a_positive_line_count(name):
    n = t_core.loc_of(name)
    assert isinstance(n, int) and n > 0


def test_core_and_baselines_export_what_jax_does():
    assert set(j_core.__all__) <= set(t_core.__all__)
    assert t_core.ALL_ALGORITHMS == j_core.ALL_ALGORITHMS
    assert set(t_core.REGISTRY) == set(j_core.REGISTRY)
    assert sorted(t_base.__all__) == sorted(j_base.__all__)
    cfg = CacheConfig(n_buckets=64, capacity=256)
    merged = t_core.merge_exec_config(cfg, t_core.ExecConfig(backend="fused"))
    assert merged.backend == "fused"


# ---------------------------------------------------------------------------
# The port's examples.
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    mods = list(_imports(path))
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "repro"}, mods
    assert "repro_torch" in top
    assert "--device" in path.read_text() or name in (
        "serve_with_prefix_cache", "train_lm")
