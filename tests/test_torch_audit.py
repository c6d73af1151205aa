"""The port's graph audit (``repro_torch.analysis.audit``) against the
JAX package's jaxpr audit.

* each GX rule fires on its seeded fixture and stays quiet on a clean
  twin;
* the port's dead outputs of ``run_trace_grouped`` (GX004) name the
  same leaves, by tree path, as the JAX package's JX004 findings in the
  same four configurations (both backends x 1 and 2 tenants), computed
  here from JAX's own audit; the other entry points have none;
* the CLI's selftest passes;
* each kernel operator's fake implementation gives its plain version's
  output shapes and dtypes (what the audit and the dry run see).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import audit


def _clean(rule):
    x = torch.ones(4)
    if rule == "GX005":
        from repro_torch.core import cache as C
        made, sigs = audit.count_captures(
            lambda k: C._scan(lambda c, x: (c, x[0]), ((k,),), (k[None],),
                              "fixed"), [(x,), (torch.ones(8),)])
        return [] if made <= sigs else ["GX005"]
    fns = {"GX001": lambda x: x.float() * 2,
           "GX002": lambda x: x.float() * 2,
           "GX003": lambda x: x * x.sum(),
           "GX004": lambda x: (x * 2, x.new_zeros(2) + x[:2])}
    return [f for f in audit.audit_fn(fns[rule], (x,), "twin")
            if f.rule == rule]


@pytest.mark.parametrize("rule", sorted(audit.RULES))
def test_each_rule_fires_on_its_fixture_and_not_on_its_twin(rule):
    assert cli.run_demo(rule), rule
    assert _clean(rule) == []


def _jax_dead_leaves():
    """(backend, tenants, leaf path) of JAX's JX004 findings on
    run_trace_grouped, as its audit_entry_points traces it."""
    from repro.analysis import jaxpr_audit as J
    from repro.core.cache import run_trace_grouped
    from repro.core.types import init_cache, init_clients
    out = set()
    for backend in ("reference", "fused"):
        for tn in (1, 2):
            cfg = J._small_cfg(backend, tn)
            st, cl = init_cache(cfg), init_clients(cfg, 4)
            keys = jnp.ones((3, 2, 4), jnp.uint32)
            fn = lambda s, c, k: run_trace_grouped(cfg, s, c, k)
            paths = [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(
                         jax.eval_shape(fn, st, cl, keys))[0]]
            for f in J.audit_closed(jax.make_jaxpr(fn)(st, cl, keys),
                                    "run_trace_grouped"):
                if f.rule == "JX004":
                    i = int(f.msg.split("[", 1)[1].split("]", 1)[0])
                    out.add((backend, tn, paths[i]))
    return out


def test_dead_outputs_mirror_jax():
    from repro_torch.core.cache import _run_trace_grouped_impl
    from repro_torch.core.types import init_cache, init_clients
    want = _jax_dead_leaves()
    assert len(want) == 16
    got = set()
    for backend in ("reference", "fused"):
        for tn in (1, 2):
            cfg = audit._small_cfg(backend, tn)
            st, cl = init_cache(cfg, "cpu"), init_clients(cfg, 4,
                                                          device="cpu")
            keys = torch.ones((3, 2, 4), dtype=torch.int64)
            for f in audit.audit_fn(
                    lambda s, c, k: _run_trace_grouped_impl(cfg, s, c, k),
                    (st, cl, keys), "run_trace_grouped",
                    audit.CONVERT_BUDGETS["run_trace_grouped"]):
                assert f.rule == "GX004", str(f)
                got.add((backend, tn, f.msg.split(" ")[0]))
    # JAX's four leaves, and replica_writes, which JAX's rule cannot see
    # through its scan (audit.py's docstring).
    port_only = {(b, tn, ".stats.replica_writes") for b, tn, _ in want}
    assert got == want | port_only
    assert {p for _, _, p in want} == set(audit.JAX_DEAD)
    assert {p for _, _, p in got} == set(audit.MIRRORED)


def test_other_entry_points_are_clean():
    assert audit._audit_ranked_eviction(torch.device("cpu")) == []
    assert audit._audit_dm(torch.device("cpu")) == []
    assert audit.audit_captures(torch.device("cpu"), widths=(1, 8)) == []


def test_selftest_passes(capsys):
    assert cli.main(["--selftest"]) == 0
    assert "all 20 rules fire" in capsys.readouterr().out


def test_each_kernel_op_fake_gives_the_plain_shapes():
    """Every custom op of kernels/library.py: its fake implementation
    gives the shapes and dtypes its CPU implementation (the plain
    version) gives, so the tracing tools see the kernels' true outputs;
    the in-place ops keep their columns."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    i64 = lambda *s, hi=64: torch.randint(0, hi, s, generator=g)
    f32 = lambda *s: torch.rand(s, generator=g)
    n, B, k = 64, 8, 3
    col = lambda: i64(n, hi=200)
    cases = [
        (ops.bucket_lookup_op, (col(), col(), i64(B)), dict(assoc=4)),
        (ops.access_probe_op, (col(), col(), col(), col(), i64(B),
                               torch.tensor(5)), dict(assoc=4, history_len=8)),
        (ops.access_probe_op, (col(), col(), col(), col(), i64(B),
                               torch.tensor(5)),
         dict(assoc=4, history_len=8, meta=(col(), col(), col()), ts=i64(B),
              experts=("lru", "lfu"))),
        (ops.hit_metadata_update_op, (col(), col(), f32(n, 4), i64(B), i64(B),
                                      i64(B), i64(B)), {}),
        (ops.ranked_eviction_op, (col(), col(), col(), col(), i64(B),
                                  i64(B, hi=2), torch.ones(B, dtype=bool),
                                  torch.ones(B, dtype=torch.int64), i64(B)),
         dict(window=8, k=k, experts=("lru", "lfu"))),
        (ops.ranked_eviction_draw_op, (col(), col(), col(), col(), i64(4, 2),
                                       f32(4, 2), torch.ones(B, dtype=bool),
                                       torch.tensor(1), i64(B)),
         dict(window=8, k=k, experts=("lru", "lfu"))),
        (ops.flash_attention_op, tuple(torch.randn(1, 16, 4, 32)
                                       for _ in range(3)), {}),
        (ops.sampled_eviction_op, (f32(n + 8), f32(n + 8), f32(n + 8),
                                   f32(n + 8), i64(B), i64(B, hi=2), 3.0),
         dict(window=8, k=k)),
        (ops.metadata_update_op, (f32(n), f32(n), i64(B), f32(B), 3.0), {}),
    ]
    shapes = lambda x: tree_map(lambda t: (tuple(t.shape), t.dtype)
                                if isinstance(t, torch.Tensor) else t, x)
    for fn, args, kw in cases:
        want = shapes(fn(*args, **kw))
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = lambda t: (mode.from_tensor(t)
                              if isinstance(t, torch.Tensor) else t)
            got = shapes(fn(*tree_map(fake, args), **tree_map(fake, kw)))
        assert got == want, fn.__name__
    cols = (col(), f32(n))
    with FakeTensorMode() as mode:
        fc = tuple(mode.from_tensor(c) for c in cols)
        ops.drop_scatter_op_(mode.from_tensor(i64(B)), fc,
                             (1, mode.from_tensor(f32(B))))
        ops.metadata_update_op_(mode.from_tensor(f32(n)),
                                mode.from_tensor(f32(n)),
                                mode.from_tensor(i64(B)),
                                mode.from_tensor(f32(B)), 1.0)
        assert shapes(fc) == shapes(cols)
