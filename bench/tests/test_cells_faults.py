"""A tiny run through the whole harness with the port's timed path
broken underneath: ``correct`` has to come out false for each fault the
cells can have."""

from __future__ import annotations

import pytest
import torch

from bench.harness.cell import run_cell
from bench.tests.tiny import tiny_cell


def _break_step(monkeypatch, fault):
    """The port's cache step with ``fault`` planted in it, wherever the
    pool's and the DM layer's step loops call it."""
    from repro_torch.core import cache as core_cache
    from repro_torch.dm import sharded_cache
    real = core_cache.access_group_
    flipped = []

    def step(cfg, state, clients, stats, keys, **kw):
        if fault == "half_batch":
            keys = keys.clone()
            keys[:, keys.shape[1] // 2:] = 0
        if fault == "state_unchanged":
            cols = {f: getattr(state, f).clone()
                    for f in core_cache.written_columns(cfg)}
            _, _, _, res = real(cfg, state, clients, stats, keys, **kw)
            for f, v in cols.items():
                getattr(state, f).copy_(v)
            return state, clients, stats, res
        st, cl, sa, res = real(cfg, state, clients, stats, keys, **kw)
        live = (keys != 0).reshape(-1).nonzero()
        if fault == "answer_altered" and not flipped and len(live):
            # The first real request's answer (a padded lane's reaches
            # no client).
            flipped.append(True)
            hit = res.hit.clone().reshape(-1)
            hit[live[0, 0]] = ~hit[live[0, 0]]
            res = res._replace(hit=hit.reshape(res.hit.shape))
        return st, cl, sa, res

    monkeypatch.setattr(core_cache, "access_group_", step)
    monkeypatch.setattr(sharded_cache, "access_group_", step)


def _no_exchange(monkeypatch):
    """The DM exchange left out: each shard receives its own source
    lanes' requests, routed for others."""
    from repro_torch.dm import sharded_cache

    def exchange(rt, serving, pool=None):
        NG, G, Sl, S, q = rt.keys.shape
        keys = rt.keys.permute(0, 2, 1, 3, 4).reshape(NG, Sl, G, S * q)
        meta = rt.meta.permute(0, 2, 1, 3, 4).reshape(NG, Sl, G, S * q)
        return sharded_cache._gate(keys, meta, serving)

    monkeypatch.setattr(sharded_cache, "_exchange", exchange)


@pytest.mark.parametrize("name,fault", [
    ("pool2m-ycsb-a", "state_unchanged"), ("pool2m-ycsb-a", "half_batch"),
    ("pool2m-ycsb-a", "answer_altered"), ("dm8x8-ycsb-a", "state_unchanged"),
    ("dm8x8-ycsb-a", "half_batch"), ("dm8x8-ycsb-a", "answer_altered"),
    ("dm8x8-ycsb-a", "exchange_left_out")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if fault == "exchange_left_out":
        _no_exchange(monkeypatch)
    else:
        _break_step(monkeypatch, fault)
    with torch.no_grad():
        out = run_cell(tiny_cell(name, rows=32), 5_000_000_029, 0.0, False,
                       device="cpu", max_calls=2)
    assert not out["correct"], out["checks"]
