"""Configurations of kind ``pool``: one cache pool driven through the
program's ``repro_torch.core.execute()`` with a ``Cache`` handle, each
call a [rows, lanes] trace planned by the program's planner, and the
plain reference of the same call."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from bench.reference import cache as ref
from bench.reference.plan import pack_rows


def _leaves(prefix: str, tup) -> dict:
    return {f"{prefix}.{f}": getattr(tup, f) for f in tup._fields}


class Program:
    """The system under test: a ``Cache`` on ``device`` and the calls
    made on it."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch.core import CacheConfig, ExecConfig, make
        cache = dict(config["cache"], experts=tuple(config["cache"]
                                                    ["experts"]))
        self.cfg = CacheConfig(**cache)
        self.exec_cfg = ExecConfig(backend=self.cfg.backend,
                                   batch=int(config["batch"]),
                                   plan=mix["plan"])
        self.cache = make(self.cfg, int(config["lanes"]), seed=seed,
                          device=device)
        self.execute = importlib.import_module("repro_torch.core.execute")

    def call(self, keys, is_write, keep: bool = False) -> dict:
        """One call; returns its record (what the metrics read of it, and
        with ``keep`` its outputs, which the check and the bytes read)."""
        res = self.execute.execute(self.cache, keys, exec_cfg=self.exec_cfg,
                                   is_write=is_write, by_lane=True)
        rec = dict(t1=time.perf_counter(), requests=int((keys != 0).sum()),
                   rows=keys.shape[0],
                   plan_s=res.plan_s,
                   steps=sum(w["n_steps"] for w in res.windows),
                   step_wall_s=sum(w["wall_s"] for w in res.windows))
        self.cache = res.cache
        if keep:
            rec["out"] = _outputs(res)
        return rec

    def leaves(self) -> dict:
        c = self.cache
        return {**_leaves("state", c.state), **_leaves("clients", c.clients),
                **_leaves("stats", c.stats)}

    def counters(self) -> dict:
        return {f: int(v) for f, v in zip(self.cache.stats._fields,
                                          self.cache.stats)}

    def release(self) -> None:
        self.cache = None


def n_shards(config: dict) -> int:
    return 1


def align(config: dict) -> int:
    """Rows a call's row count is a multiple of."""
    return 1


def width(config: dict) -> int:
    """Client lanes a call's rows hold."""
    return int(config["lanes"])


def _outputs(res) -> dict:
    """What a call produced besides the state, as host arrays: the plan,
    each round's hits by lane and the weights after each round."""
    seg = res.schedule.segments
    if len(seg) != 1 or seg[0].plan is None:
        raise ValueError("the pool reference checks one lane plan a call")
    gp = seg[0].plan
    return dict(plan=(gp.keys, gp.is_write, gp.src_t),
                hits=np.asarray(res.hits, bool), weights=res.weights)


def steps_of(record: dict):
    """Each step's requests, write flags and hits (bytes bounds)."""
    out = record["out"]
    gk, gw, _ = out["plan"]
    return gk, gw, out["hits"].reshape(gk.shape)


def reference_init(config: dict, seed: int, device) -> dict:
    cfg = ref.Config(**config["cache"])
    st = ref.init_state(cfg, device)
    cl = ref.init_clients(cfg, int(config["lanes"]), seed, device)
    return _flat(st, cl, ref.init_stats(device))


def _flat(st, cl, stats) -> dict:
    return {**{f"state.{k}": v for k, v in st.items()},
            **{f"clients.{k}": v for k, v in cl.items()},
            **{f"stats.{k}": v for k, v in stats.items()}}


def _split(leaves: dict, device) -> tuple:
    parts = ({}, {}, {})
    for k, v in leaves.items():
        part, f = k.split(".", 1)
        parts[("state", "clients", "stats").index(part)][f] = \
            v.to(device).clone()
    return parts


def reference_calls(config: dict, before: dict, calls: list,
                    device) -> tuple:
    """The reference's run of ``calls`` ((keys, is_write) each) from the
    state ``before``: (state after the last, each call's outputs)."""
    cfg = ref.Config(**config["cache"])
    st, cl, stats = _split(before, device)
    outs = []
    for keys, is_write in calls:
        gk, gw, gt = pack_rows(keys, cfg.n_buckets, int(config["batch"]),
                               is_write)
        cl, stats, hits, weights = ref.run_groups(
            cfg, st, cl, stats, torch.as_tensor(gk.astype(np.int64),
                                                device=device),
            torch.as_tensor(gw, device=device))
        G, C = gk.shape[1], gk.shape[2]
        outs.append(dict(plan=(gk, gw, gt),
                         hits=hits.reshape(-1, C).cpu().numpy(),
                         weights=ref.repeat_rows(weights, G).cpu().numpy()))
    return _flat(st, cl, stats), outs


def compare_outputs(got: dict, want: dict) -> dict:
    from bench.harness.check import ulp_gap, words_differ
    plan = sum(words_differ(a, b) for a, b in zip(got["plan"], want["plan"]))
    return dict(plan_cells=plan,
                hit_flags=words_differ(got["hits"], want["hits"]),
                f32_ulp=ulp_gap(got["weights"], want["weights"]))
