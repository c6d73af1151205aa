"""The execution facade: ``make`` a cache handle, ``execute`` a trace.

    cache = make(cfg, n_clients)              # on the card
    res = execute(cache, keys, plan="adaptive")
    res.hit_rate, res.cache, res.windows

A torch port of ``repro/core/execute.py``.  ``plan`` schedules the
[T, C] trace exactly as there: ``None`` runs sequential rounds,
``"strict"`` / ``"lane"`` one fixed-width ``GroupPlan``, ``"adaptive"``
a width per window from ``workloads/plan.py``, and a ``GroupPlan`` or
``SegmentSchedule`` runs as given.  Each segment is a Python loop of
``core/cache.py`` steps (PyTorch runs eagerly, so the JAX package's jit
runner cache has no counterpart here).  Given a ``repro_torch.dm.Cluster``
instead of a cache, the [T, S*lanes] trace runs through the DM router
and the shards' steps under the cluster's membership
(``dm/sharded_cache.py::dm_execute``), as the JAX package's Cluster
branch does.

Every tensor of a handle lives on one device.  ``make`` puts it on the
card unless the caller names another device; with no card it raises.
Segment wall times end in ``torch.cuda.synchronize()`` when the cache is
on the card, so they measure the device's work, not its enqueue.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import (TraceResult, _run_trace_grouped_impl,
                                    _run_trace_impl, make_cache)
from repro_torch.core.types import (CacheConfig, CacheState, ClientState,
                                    ExecConfig, OpStats, hit_ratio,
                                    merge_exec_config, on_device)
from repro_torch.workloads.plan import (GroupPlan, PlanCostModel, Segment,
                                        SegmentSchedule, pack_rows,
                                        plan_adaptive, plan_groups)

_UNSET = object()


class Cache(NamedTuple):
    """A cache handle: semantic config + the three state tuples."""

    cfg: CacheConfig
    state: CacheState
    clients: ClientState
    stats: OpStats

    @property
    def n_clients(self) -> int:
        return self.clients.fc_slot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.state.key.device


def make(cfg: CacheConfig, n_clients: int, seed: int = 0,
         device=None) -> Cache:
    """A fresh :class:`Cache`: an empty pool per ``cfg`` plus
    ``n_clients`` client lanes, on ``device`` (default: the card).
    Raises if the device is the card and there is none."""
    state, clients, stats = make_cache(cfg, n_clients, seed,
                                       on_device(device, "make()"))
    return Cache(cfg, state, clients, stats)


class ExecResult(NamedTuple):
    """Everything one execution produced: the advanced cache handle,
    per-round counters, and per-segment (window) execution metrics."""

    cache: Cache
    hits: np.ndarray           # i32[R] per executed round ([R, C] by lane)
    ops: np.ndarray            # i32[R]
    weights: np.ndarray        # f32[R, E] expert-weight trajectory
    #                            ([R, T, E] when n_tenants > 1)
    windows: Tuple[dict, ...]  # per-segment metrics: start/stop rows,
                               # width, steps, fill, wall_s, us_per_call
    plan_s: float              # host planning time (seconds)
    wall_s: float              # execution wall time (seconds, excludes
                               # planning)
    schedule: object           # the schedule executed

    @property
    def cfg(self) -> CacheConfig:
        return self.cache.cfg

    @property
    def state(self) -> CacheState:
        return self.cache.state

    @property
    def clients(self) -> ClientState:
        return self.cache.clients

    @property
    def stats(self) -> OpStats:
        return self.cache.stats

    @property
    def hit_rate(self) -> float:
        return hit_ratio(self.stats)


# (cfg, width, lanes, device) points that have run once.  The first
# segment of each pays the kernel build, a warm-up step and, on the card,
# the step's CUDA graph capture (``core/cache.py`` keeps the graph for
# later segments), so its wall time does not teach the cost model.
_WARM: set = set()


def _as_cache(cache) -> Cache:
    if isinstance(cache, Cache):
        return cache
    if isinstance(cache, tuple) and len(cache) == 4:
        return Cache(*cache)
    raise TypeError("execute() needs a Cache handle (or a "
                    f"(cfg, state, clients, stats) tuple); got {type(cache)!r}")


def _schedule_for(plan, keys, run_cfg: CacheConfig, xc: ExecConfig,
                  is_write, sizes, tenants,
                  model: Optional[PlanCostModel]) -> Tuple[object, float]:
    """Resolve the ``plan`` argument into a SegmentSchedule + plan time."""
    T = keys.shape[0]
    if isinstance(plan, SegmentSchedule):
        return plan, plan.plan_s
    if isinstance(plan, GroupPlan):
        rows = plan.n_groups * plan.batch
        sched = SegmentSchedule((Segment(0, rows, plan.batch, plan),),
                                np.full(1, plan.batch, np.int32),
                                max(rows, 1), 0.0)
        return sched, 0.0
    if plan is None or T == 0 or xc.batch <= 1:
        seg = (Segment(0, T, 1, None),) if T else ()
        return SegmentSchedule(seg, np.ones(0, np.int32), max(T, 1), 0.0), 0.0
    if plan == "adaptive":
        sched = plan_adaptive(
            keys, run_cfg.n_buckets, xc.batch, is_write=is_write,
            sizes=sizes, tenants=tenants, window=xc.window, model=model,
            capacity=run_cfg.capacity)
        return sched, sched.plan_s
    if plan in ("strict", "lane"):
        t0 = time.perf_counter()
        if plan == "lane":
            gp = pack_rows(keys, run_cfg.n_buckets, xc.batch,
                           is_write=is_write, sizes=sizes, tenants=tenants)
        else:
            gp = plan_groups(keys, run_cfg.n_buckets, xc.batch, scope=plan,
                             is_write=is_write, sizes=sizes, tenants=tenants)
        plan_s = time.perf_counter() - t0
        return SegmentSchedule((Segment(0, T, gp.batch, gp),),
                               np.full(1, gp.batch, np.int32),
                               max(T, 1), plan_s), plan_s
    raise ValueError(f"unknown plan mode {plan!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _execute_cluster(cluster, trace, *, plan, exec_cfg, is_write, sizes,
                     tenants) -> ExecResult:
    """The Cluster branch of :func:`execute`: one ``Cluster.execute``
    (``dm_execute``) run under the handle's membership (replica fan-out,
    re-routes and dead-shard bounces all ride the routing maps).  The DM
    router packs each destination's requests itself, so ``plan`` must be
    left unset or None."""
    if plan is not _UNSET and plan is not None:
        raise ValueError(
            "execute(Cluster, ...) runs the DM router, which packs "
            "per-destination request groups itself; pass plan=None (or "
            "omit it)")
    xc = exec_cfg if exec_cfg is not None else cluster.cfg.split()[1]
    keys = np.asarray(trace, np.uint32)
    if keys.ndim != 2:
        raise ValueError(f"trace must be [T, S*lanes]; got {keys.shape}")
    T, L = keys.shape
    if L % cluster.n_shards != 0:
        raise ValueError(
            f"trace width {L} not divisible by n_shards={cluster.n_shards}")
    warm_key = ("cluster", cluster.local, cluster.n_shards, xc.route_factor,
                keys.shape, str(cluster.device))
    was_warm = warm_key in _WARM
    _sync(cluster.device)
    t0 = time.perf_counter()
    new_cluster, hits = cluster.execute(keys, is_write, sizes, tenants,
                                        route_factor=xc.route_factor)
    hits = hits.cpu().numpy()
    wall = time.perf_counter() - t0
    _WARM.add(warm_key)

    ops = (keys != 0).sum(axis=1).astype(np.int32)
    n_req = int(ops.sum())
    windows = (dict(start=0, stop=T, width=1, n_steps=T, n_requests=n_req,
                    fill=1.0, wall_s=wall,
                    us_per_call=wall * 1e6 / max(n_req, 1),
                    compiled=not was_warm),)
    return ExecResult(new_cluster, hits.sum(axis=1).astype(np.int32), ops,
                      np.zeros((0,), np.float32), windows, 0.0, wall, None)


def execute(cache, trace, *, plan=_UNSET, exec_cfg: ExecConfig | None = None,
            is_write=None, sizes=None, tenants=None,
            model: Optional[PlanCostModel] = None,
            by_lane: bool = False) -> ExecResult:
    """Execute a [T, C] request trace against a cache, planned.

    Args:
      cache: :class:`Cache` handle (or (cfg, state, clients, stats)), or
        a ``repro_torch.dm.Cluster``: the trace is then [T, S*lanes] and
        runs through the DM router under the cluster's membership
        (``_execute_cluster``).
      trace: u32[T, C] keys (numpy); 0 marks a padded no-op lane.
      plan: ``"adaptive" | "strict" | "lane" | None``, or a precomputed
        ``GroupPlan`` / ``SegmentSchedule``.  Defaults to
        ``exec_cfg.plan``.
      exec_cfg: execution-time knobs; ``None`` derives one from the cache
        config's ``backend`` field.
      is_write / sizes / tenants: optional [T, C] op arrays.
      model: optional :class:`PlanCostModel` shared across calls.
      by_lane: ``hits``/``ops`` per executed round and lane ([R, C]), so
        a caller can split them by the lanes' tenants (the JAX package's
        ``execute`` has no such option; ``False`` gives its [R] counts).

    Returns an :class:`ExecResult`; ``hits``/``ops`` are per executed
    round, in the schedule's round order.
    """
    from repro_torch.dm.cluster import Cluster
    if isinstance(cache, Cluster):
        return _execute_cluster(cache, trace, plan=plan, exec_cfg=exec_cfg,
                                is_write=is_write, sizes=sizes,
                                tenants=tenants)
    cache = _as_cache(cache)
    if exec_cfg is None:
        exec_cfg = cache.cfg.split()[1]
    run_cfg = merge_exec_config(cache.cfg, exec_cfg)
    if plan is _UNSET:
        plan = exec_cfg.plan
    dev = cache.device

    keys = np.asarray(trace, np.uint32)
    if keys.ndim != 2:
        raise ValueError(f"trace must be [T, C]; got shape {keys.shape}")
    T, C = keys.shape
    is_write_np = None if is_write is None else np.asarray(is_write, bool)
    sizes_np = None if sizes is None else np.asarray(sizes, np.uint32)
    tenants_np = None if tenants is None else np.asarray(tenants, np.uint32)

    sched, plan_s = _schedule_for(plan, keys, run_cfg, exec_cfg,
                                  is_write_np, sizes_np, tenants_np, model)

    def _t(arr, dtype=torch.int64):
        return torch.as_tensor(np.asarray(arr).astype(
            np.bool_ if dtype == torch.bool else np.int64), device=dev)

    state, clients, stats = cache.state, cache.clients, cache.stats
    hits_parts, ops_parts, w_parts, windows = [], [], [], []
    wall_total = 0.0
    for seg in sched.segments:
        rows = seg.stop - seg.start
        if rows <= 0:
            continue
        grouped = seg.width > 1
        if grouped:
            gp = seg.plan
            args = (_t(gp.keys), _t(gp.is_write, torch.bool), _t(gp.sizes),
                    None if gp.tenants is None else _t(gp.tenants))
            impl = _run_trace_grouped_impl
            n_req, n_steps, fill = gp.n_scheduled, gp.n_groups, gp.fill
        else:
            sl = slice(seg.start, seg.stop)
            args = (_t(keys[sl]),
                    None if is_write_np is None
                    else _t(is_write_np[sl], torch.bool),
                    None if sizes_np is None else _t(sizes_np[sl]),
                    None if tenants_np is None else _t(tenants_np[sl]))
            impl = _run_trace_impl
            n_req = int((keys[sl] != 0).sum())
            n_steps, fill = rows, 1.0
        warm_key = (run_cfg, seg.width, C, str(dev))
        was_warm = warm_key in _WARM
        _sync(dev)
        t0 = time.perf_counter()
        res: TraceResult = impl(run_cfg, state, clients, *args,
                                by_lane=by_lane)
        _sync(dev)
        wall = time.perf_counter() - t0
        _WARM.add(warm_key)
        wall_total += wall
        state, clients = res.state, res.clients
        stats = OpStats(*[a + b for a, b in zip(stats, res.stats)])
        hits_parts.append(res.hits.cpu().numpy().astype(np.int32))
        ops_parts.append(res.ops.cpu().numpy().astype(np.int32))
        w_parts.append(res.weights.cpu().numpy())
        windows.append(dict(
            start=seg.start, stop=seg.stop, width=seg.width,
            n_steps=n_steps, n_requests=n_req, fill=round(float(fill), 4),
            wall_s=wall, us_per_call=wall * 1e6 / max(n_req, 1),
            compiled=not was_warm))
        if model is not None and was_warm and n_steps > 0:
            model.observe(seg.width, wall * 1e6 / n_steps,
                          eff=rows / (n_steps * seg.width))

    new_cache = Cache(cache.cfg, state, clients, stats)
    empty = np.zeros((0, C) if by_lane else 0, np.int32)
    hits = np.concatenate(hits_parts) if hits_parts else empty
    ops = np.concatenate(ops_parts) if ops_parts else empty
    weights = (np.concatenate(w_parts)
               if w_parts else np.zeros((0,), np.float32))
    return ExecResult(new_cache, hits, ops, weights, tuple(windows),
                      plan_s, wall_total, sched)
