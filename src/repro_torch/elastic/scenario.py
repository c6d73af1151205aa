"""Scenario driver: declarative elasticity timelines (DESIGN.md §8), a
torch port of ``repro/elastic/scenario.py``.

A scenario is a request trace plus a timeline of reconfiguration events

    timeline = [(t, ("set_capacity", 16384)),
                (t2, ("set_lanes", 16)),          # per-shard lane width
                (t3, ("switch_workload", "scan"))]

run through the live DM cache on the card (or the CPU).  The driver
runs the trace in chunks through ``dm_execute``, applies events through
the ``elastic.resize`` entry points at their step index, and records
per-window timelines of measured counters: hit rate (the canonical
``hit_ratio``), model throughput, eviction and drop pressure, byte
occupancy (``blocks_cached`` / ``bytes_cached``), and the migration
bytes and drain steps each event cost.  Capacities are in 64B blocks.

An ``Autoscaler``, a ``TenantArbiter``, a ``WidthController`` and a
``HealthMonitor`` may close the loop at every window boundary, as in the
JAX package; the window dicts and the event log carry the same fields
and values.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.baselines.systems import DittoModel
from repro_torch.core.hashing import bucket_of, hash_key
from repro_torch.core.types import CacheConfig, OpStats, stats_delta
from repro_torch.dm.cluster import Cluster
from repro_torch.dm.sharded_cache import dm_execute
from repro_torch.elastic.controller import (Autoscaler, HealthMonitor,
                                            TenantArbiter, TenantWindow,
                                            WidthController, WindowMetrics)
from repro_torch.elastic.resize import (ResizeReport, enforce_budget,
                                        resize_lanes, resize_memory,
                                        set_tenant_budgets)

Event = Tuple[str, object]          # ("set_capacity"|"set_lanes"|
#                                   #  "set_tenant_budgets"|
#                                   #  "switch_workload"|"set_replicas"|
#                                   #  "fail_shard"|"mark_failed"|
#                                   #  "recover_shard", arg)


class ScenarioResult(NamedTuple):
    windows: list       # per-window dicts (t0, t1, hit_rate, tput_mops,
                        # capacity/blocks_cached in 64B blocks — the unit
                        # of CacheState.bytes_cached — and bytes_cached
                        # in REAL bytes: == 64 * blocks_cached)
    events: list        # applied events: dict(t, event, arg, report)
    dm: object          # final DMCache (for state inspection in tests)
    cluster: object = None   # final dm.Cluster membership handle

    def phase(self, t0: float, t1: float, key: str) -> np.ndarray:
        """Values of `key` for windows fully inside [t0, t1)."""
        return np.array([w[key] for w in self.windows
                         if w["t0"] >= t0 and w["t1"] <= t1])


def _round_capacity(target: int, cfg: CacheConfig, n_shards: int) -> int:
    # No upper clamp: a block budget beyond what the table holds in
    # objects is legitimate for big-object pools; closed-loop growth is
    # bounded by AutoscalerConfig's max_capacity instead.
    target = max(int(target), n_shards)
    return (target // n_shards) * n_shards


def _as_sized_stream(arg, default_sizes=None, default_tenants=None):
    """A workload is a flat key stream, a (keys, sizes) pair, or a
    (keys, sizes, tenants) triple."""
    tenants = None
    if isinstance(arg, tuple):
        if default_sizes is not None or default_tenants is not None:
            raise ValueError(
                "pass sizes/tenants either inside the workload tuple or "
                "as the sizes=/tenants= kwargs, not both")
        if len(arg) == 2:
            keys, sizes = arg
        elif len(arg) == 3:
            keys, sizes, tenants = arg
            tenants = np.asarray(tenants, np.uint32)
        else:
            raise ValueError(
                f"workload tuple must be (keys, sizes[, tenants]); "
                f"got {len(arg)} entries")
        keys = np.asarray(keys, np.uint32)
        sizes = np.asarray(sizes, np.uint32)
    else:
        keys = np.asarray(arg, np.uint32)
        sizes = (np.ones_like(keys, np.uint32) if default_sizes is None
                 else np.asarray(default_sizes, np.uint32))
        if default_tenants is not None:
            tenants = np.asarray(default_tenants, np.uint32)
    if tenants is None:
        tenants = np.zeros_like(keys, np.uint32)
    if sizes.shape != keys.shape:
        raise ValueError(
            f"sizes shape {sizes.shape} != keys shape {keys.shape}")
    if tenants.shape != keys.shape:
        raise ValueError(
            f"tenants shape {tenants.shape} != keys shape {keys.shape}")
    return keys, sizes, tenants


def _host_stats(stats: OpStats) -> OpStats:
    """The shard-summed counters as host integers (one read)."""
    return OpStats(*torch.stack([f.sum() for f in stats]).tolist())


def run_scenario(cfg: CacheConfig, keys, timeline: Sequence[Tuple[int, Event]],
                 *, n_shards: int = 1, lanes_per_shard: int = 8,
                 horizon: Optional[int] = None, window: int = 32,
                 workloads: Optional[dict] = None,
                 controller: Optional[Autoscaler] = None,
                 arbiter: Optional[TenantArbiter] = None,
                 offered_mops: Optional[Callable[[int], float]] = None,
                 seed: int = 0, drain_batch: int = 64,
                 drain_max_steps: int = 256,
                 sizes=None, tenants=None,
                 width_controller: Optional[WidthController] = None,
                 health: Optional[HealthMonitor] = None,
                 replicate_hot: int = 0, replica_ema: float = 0.5,
                 device=None) -> ScenarioResult:
    """Run a [T, lanes] trace through the DM cache under an event stream.

    Args:
      keys: flat u32 request stream (wraps around); the initial workload.
      timeline: [(step, (event, arg))] applied when the step begins.
      workloads: name -> flat stream OR (stream, sizes) pair OR
        (stream, sizes, tenants) triple, for ("switch_workload", name).
      controller: optional Autoscaler whose window decisions become events.
      arbiter: optional TenantArbiter (n_tenants > 1): at each window
        boundary it sees per-tenant occupancy and hit-rate windows, and
        its proposed budget splits apply as ("set_tenant_budgets", ...).
      offered_mops: demand curve (step -> Mops) for compute decisions.
      sizes: optional per-request object sizes (64B blocks) aligned with
        `keys`; defaults to uniform 1-block objects.
      tenants: optional per-request tenant ids aligned with `keys`;
        defaults to tenant 0 everywhere.
      width_controller: optional :class:`WidthController`.  The trace
        runs through ``dm_execute`` in chunks; without a controller each
        chunk spans to the next event or window boundary, with one the
        chunk width adapts online from measured per-chunk wall times
        (chunking is execution only: the results are bit-equal at any
        width).
      health: optional :class:`HealthMonitor`.  At every window boundary
        it observes ground-truth heartbeats (``cluster.alive``); shards it
        declares failed are re-routed by ``Cluster.mark_failed``, so a
        ("fail_shard", k) event dips until detection.  Without a monitor,
        failures bounce until an explicit ("mark_failed", k) or
        ("recover_shard", k).
      replicate_hot: when > 0, keep a per-global-bucket load EMA (decay
        ``replica_ema``) and re-elect replicas for the hottest
        ``replicate_hot`` buckets at every window boundary.
      device: where the cluster lives (default: the card; raises
        without one), as ``Cluster.make``.
    """
    cluster = Cluster.make(cfg, n_shards, lanes_per_shard, device=device)
    local = cluster.local
    dm = cluster.dm
    dev = cluster.device
    member = cluster.membership()
    bucket_loads = np.zeros(cfg.n_buckets, np.float64)
    win_counts = np.zeros(cfg.n_buckets, np.float64)
    run_shapes: set = set()
    model = DittoModel()
    workloads = workloads or {}
    n_ten = cfg.n_tenants

    stream, size_stream, ten_stream = _as_sized_stream(keys, sizes, tenants)
    lanes = lanes_per_shard
    capacity = cfg.budget_blocks        # the byte budget Cluster.make sets
    tenant_budgets = list(cfg.tenant_budgets)
    if horizon is None:
        horizon = len(stream) // (n_shards * lanes)
    pending = sorted(timeline, key=lambda e: e[0])

    windows, events_log = [], []
    pos = 0
    win_t0 = 0
    win_mig = win_drain = 0
    win_events: list[str] = []
    last_stats = _host_stats(dm.stats)
    # Per-tenant window counters, accumulated on the host from the routed
    # hit masks (router-dropped requests count as misses here).
    t_ops = np.zeros(n_ten, np.int64)
    t_hits = np.zeros(n_ten, np.int64)
    t_req_blocks = np.zeros(n_ten, np.float64)
    t_hit_blocks = np.zeros(n_ten, np.float64)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    def apply_event(t: int, name: str, arg) -> None:
        nonlocal dm, lanes, capacity, win_mig, win_drain, stream, pos
        nonlocal size_stream, ten_stream, tenant_budgets, cluster, member
        report = ResizeReport(0, 0, 0, 0)
        member_changed = False
        if name == "set_capacity":
            capacity = _round_capacity(int(arg), cfg, n_shards)
            dm, report = resize_memory(
                local, dm, capacity, batch_per_shard=drain_batch,
                max_steps=drain_max_steps)
        elif name == "set_lanes":
            lanes = max(1, int(arg))
            dm, report = resize_lanes(local, dm, lanes, seed=seed + 1 + t)
        elif name == "set_tenant_budgets":
            tenant_budgets = [int(b) for b in arg]
            dm = set_tenant_budgets(dm, tenant_budgets, n_shards)
        elif name == "switch_workload":
            stream, size_stream, ten_stream = _as_sized_stream(
                workloads[arg] if isinstance(arg, str) else arg)
            pos = 0
        elif name == "set_replicas":
            # int: elect that many hot buckets from the load EMA; array:
            # install the explicit per-bucket secondary map.
            cluster = cluster._replace(dm=dm)
            if isinstance(arg, (int, np.integer)):
                cluster = cluster.elect_replicas(bucket_loads, int(arg))
            else:
                cluster = cluster.with_replicas(arg)
            dm, member_changed = cluster.dm, True
        elif name == "fail_shard":
            # Ground truth only: the shard's state is wiped and it stops
            # serving, but routing still targets it (bounces count as
            # drops) until the health monitor or a mark_failed event
            # re-routes.  That gap is the detection latency.
            cluster = cluster._replace(dm=dm).inject_failure(int(arg))
            dm, member_changed = cluster.dm, True
        elif name == "mark_failed":
            cluster = cluster._replace(dm=dm).mark_failed(int(arg))
            dm, member_changed = cluster.dm, True
        elif name == "recover_shard":
            cluster, report = cluster._replace(dm=dm).recover(int(arg))
            dm, member_changed = cluster.dm, True
        else:
            raise ValueError(f"unknown scenario event {name!r}")
        if member_changed:
            member = cluster.membership()
        win_mig += report.migration_bytes
        win_drain += report.drain_steps
        win_events.append(name)
        events_log.append(dict(t=t, event=name, arg=arg,
                               report=report._asdict()))

    t = 0
    while t < horizon:
        while pending and pending[0][0] <= t:
            _, (name, arg) = pending.pop(0)
            apply_event(t, name, arg)

        L = n_shards * lanes
        # Chunk: as many rounds as possible in one dm_execute call, up to
        # the next event, the window boundary, the horizon and (when
        # adapting) the controller's width.  Lanes and the workload are
        # constant within a chunk by construction.
        stop = min(horizon, (t // window + 1) * window)
        if pending:
            stop = min(stop, pending[0][0])
        if width_controller is not None:
            stop = min(stop, t + width_controller.width)
        n = stop - t
        idx = (pos + np.arange(n * L)) % len(stream)
        pos += n * L
        step_keys = stream[idx].reshape(n, L)
        step_ten = np.minimum(ten_stream[idx],
                              np.uint32(n_ten - 1)).reshape(n, L)
        step_sz = size_stream[idx].reshape(n, L)
        warm = (n, L) in run_shapes
        tc0 = time.perf_counter()
        dm, hits = dm_execute(local, dm, put(step_keys), obj_size=put(step_sz),
                              tenant=put(step_ten), member=member)
        hn = hits.cpu().numpy()              # host sync: bounds the wall
        wall = time.perf_counter() - tc0
        if replicate_hot > 0:
            # Per-bucket offered load for this chunk (the router's hash),
            # accumulated into the window's counts.
            kk = step_keys.ravel()
            kk = kk[kk != 0]
            gb = bucket_of(hash_key(torch.from_numpy(kk.astype(np.int64))),
                           cfg.n_buckets).numpy()
            win_counts += np.bincount(gb, minlength=cfg.n_buckets)
        run_shapes.add((n, L))
        if width_controller is not None and warm:
            # Measured throughput closes the loop: warm chunk timings
            # refine the width decision (first runs of a shape never count).
            width_controller.observe_chunk(n, wall)
        ops_mask = step_keys != 0
        np.add.at(t_ops, step_ten.ravel(), ops_mask.ravel())
        np.add.at(t_hits, step_ten.ravel(), (hn & ops_mask).ravel())
        np.add.at(t_req_blocks, step_ten.ravel(),
                  np.where(ops_mask, step_sz, 0).ravel())
        np.add.at(t_hit_blocks, step_ten.ravel(),
                  np.where(hn & ops_mask, step_sz, 0).ravel())
        t = stop

        if t % window == 0 or t == horizon:
            # Maintenance sweep: hold the byte budget between events (the
            # batched sampler alone drifts at low live density).
            dm, enforced = enforce_budget(local, dm,
                                          batch_per_shard=drain_batch)
            total = _host_stats(dm.stats)
            d = stats_delta(total, last_stats)
            last_stats = total
            ops = float(d.gets + d.sets)
            occ = torch.cat([dm.state.n_cached.sum()[None],
                             dm.state.bytes_cached.sum()[None],
                             dm.state.tenant_bytes.sum(dim=0)]).tolist()
            n_cached, blocks, ten_blocks = occ[0], occ[1], occ[2:]
            tput = model.throughput(L, d, hit_rate=1.0) / 1e6 if ops else 0.0
            m = WindowMetrics.from_stats(
                d, n_cached=n_cached, capacity=capacity, lanes=L,
                blocks_cached=blocks, capacity_blocks=capacity,
                offered_mops=offered_mops(t - 1) if offered_mops else None,
                tput_mops=tput)
            # Per-tenant occupancy (exact, from the pool) and hit rates
            # (accumulated on the host from the routed hit masks).
            ten_hr = (t_hits / np.maximum(t_ops, 1)).tolist()
            ten_bhr = (t_hit_blocks / np.maximum(t_req_blocks, 1)).tolist()
            ten_windows = [TenantWindow(
                occupancy_blocks=int(ten_blocks[i]),
                budget_blocks=int(tenant_budgets[i]),
                hit_rate=float(ten_hr[i]),
                miss_blocks=float(t_req_blocks[i] - t_hit_blocks[i]))
                for i in range(n_ten)]
            windows.append(dict(
                t0=win_t0, t1=t, capacity=capacity, lanes=L,
                hit_rate=m.hit_rate, tput_mops=tput, n_cached=n_cached,
                blocks_cached=blocks, bytes_cached=blocks * 64,
                evictions=int(d.evictions), insert_drops=int(d.insert_drops),
                migration_bytes=win_mig, drain_steps=win_drain,
                enforced_evictions=enforced, events=list(win_events),
                route_drops=int(d.route_drops),
                replica_writes=int(d.replica_writes),
                replica_drops=int(d.replica_drops),
                l0_hits=int(d.l0_hits),
                l0_invalidations=int(d.l0_invalidations),
                alive=[bool(a) for a in cluster.alive],
                routed=[bool(r) for r in cluster.routed],
                n_replicated=int((cluster.replicas < n_shards).sum()),
                tenant_blocks=[int(b) for b in ten_blocks],
                tenant_budget=[int(b) for b in tenant_budgets],
                tenant_hit_rate=[round(float(h), 6) for h in ten_hr],
                tenant_byte_hit_rate=[round(float(h), 6) for h in ten_bhr]))
            win_t0 = t
            win_mig = win_drain = 0
            win_events = []
            t_ops[:] = 0
            t_hits[:] = 0
            t_req_blocks[:] = 0.0
            t_hit_blocks[:] = 0.0

            # Heartbeat detection: the monitor sees ground truth and its
            # verdicts re-route.  Recoveries need no action here: the
            # recover_shard event restores routing itself.
            if health is not None:
                newly_failed, _ = health.observe(cluster.alive)
                for k in newly_failed:
                    apply_event(t, "mark_failed", k)
            # Hot-bucket replica election from the load EMA.
            if replicate_hot > 0:
                bucket_loads *= replica_ema
                bucket_loads += (1.0 - replica_ema) * win_counts
                win_counts[:] = 0.0
                cluster = cluster._replace(dm=dm).elect_replicas(
                    bucket_loads, replicate_hot)
                member = cluster.membership()

            if width_controller is not None:
                width_controller.propose()
            if controller is not None:
                dec = controller.observe(m)
                if dec.action == "grow_memory" or dec.action == "shrink_memory":
                    apply_event(t, "set_capacity", dec.target)
                elif dec.action in ("grow_lanes", "shrink_lanes"):
                    per_shard = -(-dec.target // n_shards)
                    apply_event(t, "set_lanes", per_shard)
            if arbiter is not None and n_ten > 1:
                prop = arbiter.propose(capacity, ten_windows)
                if prop is not None:
                    apply_event(t, "set_tenant_budgets", prop)

    return ScenarioResult(windows, events_log, dm, cluster._replace(dm=dm))
