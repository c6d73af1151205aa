"""The cache options no other port test sets, against the JAX package, on
the CPU: the three Ditto toggles off one at a time and all four off (FC
too) on both backends, and the experts the ``execute`` tests leave out
(gds, lirs, lruk, lfuda, mru, size, fifo; the fused backend refuses
them, as the JAX package's does) on the reference backend, sequential
and as a strict ``GroupPlan`` of width 8.

Tolerances are ``test_torch_cache.py``'s: integer state, ``OpStats``,
the FC-cache columns and the per-round hits bit-equal; the compounded
weights within 4 ulp on YCSB-A with lazy weight updates, and within 16
where they compound more syncs' ``exp`` rounding (YCSB-B, or
``use_lwu=False``, which syncs on every regret); ``ext`` and ``gds_L``
within 4.
"""

import pytest

from repro.core import types as j_types
from repro.core.execute import execute as j_execute
from repro.core.execute import make as j_make
from repro.workloads import plan as j_plan
from repro_torch.core import types as t_types
from repro_torch.core.execute import execute as t_execute
from repro_torch.core.execute import make as t_make
from repro_torch.workloads import plan as t_plan
from test_torch_cache import C, EXPERTS, _assert_same, _trace

N = 800
TOGGLES = {"no_lwu": dict(use_lwu=False), "no_lwh": dict(use_lwh=False),
           "no_sfht": dict(use_sfht=False),
           "all_off": dict(use_lwu=False, use_lwh=False, use_sfht=False,
                           use_fc=False)}


def _run(kw, workload, plan=None):
    cfg_j, cfg_t = j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)
    keys, wr = _trace(workload, n=N)
    jp = tp = None
    if plan == "strict8":
        jp = j_plan.plan_groups(keys, cfg_j.n_buckets, 8, scope="strict",
                                is_write=wr)
        tp = t_plan.plan_groups(keys, cfg_t.n_buckets, 8, scope="strict",
                                is_write=wr)
    jr = j_execute(j_make(cfg_j, C, 0), keys, plan=jp, is_write=wr)
    tr = t_execute(t_make(cfg_t, C, 0, device="cpu"), keys, plan=tp,
                   is_write=wr)
    lazy = kw.get("use_lwu", True)
    _assert_same(tr, jr, weight_ulp=4 if workload == "A" and lazy else 16)
    assert int(tr.stats.evictions) > 0
    return tr


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("toggle", list(TOGGLES))
def test_ditto_toggles_off_match_jax(toggle, backend):
    kw = dict(n_buckets=64, assoc=4, capacity=96, sync_period=4,
              experts=EXPERTS[backend], backend=backend, **TOGGLES[toggle])
    tr = _run(kw, "A")
    assert (int(tr.stats.fc_hits) > 0) == kw.get("use_fc", True)


@pytest.mark.parametrize("plan", [None, "strict8"])
@pytest.mark.parametrize("expert", ["gds", "lirs", "lruk", "lfuda", "mru",
                                    "size", "fifo"])
def test_other_experts_match_jax(expert, plan):
    kw = dict(n_buckets=64, assoc=4, capacity=96, sync_period=4,
              experts=(expert, "lru", "lfu"), backend="reference")
    tr = _run(kw, "B", plan)
    assert int(tr.stats.regrets) > 0 and int(tr.stats.weight_syncs) > 0
