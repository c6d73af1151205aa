"""The port's spans and counters (``core/spans.py``) on the CPU.

With no profiler recording, a span enters nothing; under
``torch.profiler`` one ``execute()`` call marks its planning, uploads,
segment, the step loop's carry copy and steps, the counters' merge and
the readback, nested inside ``ditto.execute`` in the order they run,
and the call's results are the same as without the profiler.  No step
is captured as a CUDA graph on the CPU.  The card's captures are
``tests/test_torch_cuda.py``'s.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import CacheConfig, ExecConfig, execute, make, spans
from repro_torch.dm import Cluster
from repro_torch.workloads import gen

C = 8
CFG = CacheConfig(n_buckets=64, assoc=4, capacity=96, sync_period=4)
LANE = ExecConfig(batch=4, plan="lane")


def _trace(rows=40, seed=7, width=C):
    keys, wr = gen.ycsb("A", rows * width, n_keys=300, seed=seed)
    return gen.interleave(keys, width, wr)


def _tree(prof) -> list:
    """The ``ditto.*`` host spans as (depth, name), in start order; a
    span's depth is the number of ``ditto.*`` spans open around it."""
    ev = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("ditto.")
                 and str(e.device_type()).endswith("CPU")))
    out, open_ = [], []
    for t0, neg, name in ev:
        while open_ and open_[-1] <= t0:
            open_.pop()
        out.append((len(open_), name))
        open_.append(t0 - neg)
    return out


def _same(a, b) -> None:
    assert np.array_equal(a.hits, b.hits)
    assert np.array_equal(a.ops, b.ops)
    assert np.array_equal(a.weights, b.weights)
    drop = ("wall_s", "compiled")       # a clock; the process's first run
    assert [{k: v for k, v in w.items() if k not in drop}
            for w in a.windows] == [{k: v for k, v in w.items()
                                     if k not in drop} for w in b.windows]
    for x, y in zip((a.state, a.clients, a.stats),
                    (b.state, b.clients, b.stats)):
        for f in x._fields:
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_a_span_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    keys, wr = _trace()
    r = execute(make(CFG, C, 0, device="cpu"), keys, exec_cfg=LANE,
                is_write=wr)
    assert int(r.stats.gets + r.stats.sets) == int((keys != 0).sum())
    with spans.span("ditto.execute") as s:
        assert s is None


def test_one_call_marks_the_span_tree_in_order():
    keys, wr = _trace()
    cache = make(CFG, C, 0, device="cpu")
    execute(cache, keys, exec_cfg=LANE, is_write=wr)     # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = execute(cache, keys, exec_cfg=LANE, is_write=wr)
    (w,) = r.windows
    assert w["n_steps"] > 1
    assert _tree(prof) == [
        (0, "ditto.execute"),
        (1, "ditto.plan"),
        (1, "ditto.upload"),
        (1, "ditto.segment"),
        (2, "ditto.scan.copy_in"),
        *[(2, "ditto.scan.step")] * w["n_steps"],
        (1, "ditto.merge_stats"),
        (1, "ditto.readback")]


def test_a_cluster_call_marks_its_steps_and_readback():
    cl = Cluster.make(CFG, 4, 4, device="cpu")
    keys, wr = _trace(rows=6, width=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        execute(cl, keys, is_write=wr)
    tree = _tree(prof)
    assert tree[0] == (0, "ditto.execute")
    assert tree[-1] == (1, "ditto.readback")
    assert all(d >= 1 for d, _ in tree[1:])
    assert {n for _, n in tree[1:-1]} == {"ditto.scan.copy_in",
                                          "ditto.scan.step"}


@pytest.mark.parametrize("plan", ["lane", None])
def test_the_profiler_leaves_the_results_bit_equal(plan):
    keys, wr = _trace()
    xc = ExecConfig(batch=4, plan=plan)
    plain = execute(make(CFG, C, 0, device="cpu"), keys, exec_cfg=xc,
                    is_write=wr)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = execute(make(CFG, C, 0, device="cpu"), keys, exec_cfg=xc,
                         is_write=wr)
    _same(plain, traced)


def test_the_cpu_captures_no_graph():
    before = spans.counters()
    keys, wr = _trace()
    r = execute(make(CFG, C, 0, device="cpu"), keys, exec_cfg=LANE,
                is_write=wr)
    execute(r.cache, keys, plan=None, is_write=wr)
    assert spans.counters() == before
    assert "graph_captures" in before


def test_count_adds_to_a_copy_the_caller_cannot_change():
    before = spans.counters()
    spans.count("test_spans.calls")
    spans.count("test_spans.calls", 2)
    after = spans.counters()
    after["graph_captures"] += 5
    assert spans.counters()["test_spans.calls"] \
        == before.get("test_spans.calls", 0) + 3
    assert spans.counters()["graph_captures"] == before["graph_captures"]
