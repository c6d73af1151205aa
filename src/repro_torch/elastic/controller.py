"""Feedback autoscaler for the elastic runtime (DESIGN.md §8), and the
width controller, the tenant arbiter and the shard health monitor: the
port's copy of ``repro/elastic/controller.py``, host Python over the
port's ``hit_ratio`` and ``PlanCostModel`` (a window's counters are read
off the card once, by the scenario driver).

Watches per-window counters (the `OpStats` deltas the scenario driver
produces) and emits scale decisions against configurable targets. The
design goal is *stability first*: every trigger has a patience streak
(the violating condition must persist), the grow/shrink bands do not
overlap (dead band between them), and every action starts a cooldown —
so a steady workload can never make the controller oscillate.

Memory decisions key off hit rate vs. eviction pressure: a hit rate
below the floor only means "too small" when the pool is actually
churning (evictions or insert drops); an over-provisioned pool shows a
comfortable hit rate, low churn, and occupancy below the shrink
watermark. Compute decisions key off utilization — offered load vs. the
achievable throughput at the current lane count, which the scenario
driver derives from measured counters via the cost model (`DittoModel`,
the same model the benchmarks use) and reports in `WindowMetrics`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

from repro_torch.core.types import hit_ratio
from repro_torch.workloads.plan import PlanCostModel


class WindowMetrics(NamedTuple):
    """One observation window, distilled from OpStats deltas."""

    hit_rate: float
    evictions_per_op: float
    insert_drops_per_op: float
    n_cached: int
    capacity: int
    lanes: int
    offered_mops: Optional[float] = None   # demand, for compute scaling
    tput_mops: float = 0.0                 # achievable at current lanes
    # Byte-accurate occupancy (64B blocks). When capacity_blocks > 0 the
    # memory decisions key off these instead of object counts — growing
    # and shrinking *memory*, as the paper claims, not ±N objects.
    blocks_cached: int = 0
    capacity_blocks: int = 0

    @classmethod
    def from_stats(cls, delta, *, n_cached, capacity, lanes,
                   blocks_cached=0, capacity_blocks=0,
                   offered_mops=None, tput_mops=0.0) -> "WindowMetrics":
        """Distill an OpStats window delta. The hit rate is THE canonical
        `hit_ratio` (executed ops only — router drops excluded), so every
        consumer of WindowMetrics agrees on the denominator."""
        ops = max(float(delta.gets + delta.sets), 1.0)
        return cls(hit_rate=hit_ratio(delta),
                   evictions_per_op=float(delta.evictions) / ops,
                   insert_drops_per_op=float(delta.insert_drops) / ops,
                   n_cached=n_cached, capacity=capacity, lanes=lanes,
                   offered_mops=offered_mops, tput_mops=tput_mops,
                   blocks_cached=blocks_cached,
                   capacity_blocks=capacity_blocks)

    @property
    def occupancy(self) -> float:
        """Fraction of the budget in use — bytes when available."""
        if self.capacity_blocks > 0:
            return self.blocks_cached / self.capacity_blocks
        return self.n_cached / max(self.capacity, 1)


class Decision(NamedTuple):
    action: str          # none | grow_memory | shrink_memory
    #                    # | grow_lanes | shrink_lanes
    target: int          # new global capacity / new total lane count
    reason: str


NONE = Decision("none", 0, "")


@dataclasses.dataclass
class AutoscalerConfig:
    # --- memory targets ------------------------------------------------
    hit_rate_floor: float = 0.80      # grow below this (if churning)
    hit_rate_slack: float = 0.10      # shrink only above floor + slack
    evict_pressure: float = 0.02      # evictions/op that count as churn
    occupancy_low: float = 0.60       # shrink only if pool this empty OR
    #                                 # hit rate comfortably above band
    mem_step: float = 2.0             # multiplicative resize step
    # min/max memory bounds share the unit of the window's reported
    # capacity: 64B blocks when WindowMetrics carries capacity_blocks
    # (the byte-accurate runtime), live objects otherwise — tune them in
    # blocks for sized workloads.
    min_capacity: int = 1024
    max_capacity: int = 1 << 20
    # --- compute targets -----------------------------------------------
    util_high: float = 0.90           # offered / achievable: add lanes
    util_low: float = 0.35            # remove lanes below this
    lane_step: float = 2.0
    min_lanes: int = 1
    max_lanes: int = 4096
    # --- stability -----------------------------------------------------
    patience: int = 3                 # consecutive violating windows
    cooldown: int = 5                 # quiet windows after any action

    def __post_init__(self):
        # Non-overlapping bands are what make steady workloads stable:
        # shrinking must not re-trigger the grow condition and vice versa.
        assert self.hit_rate_slack > 0
        assert self.util_low * self.lane_step < self.util_high, \
            "lane bands overlap: shrinking would immediately re-grow"


class Autoscaler:
    """Hysteretic feedback controller: observe a window, maybe act."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = cfg or AutoscalerConfig()
        self._cooldown = 0
        self._streak = {"grow_memory": 0, "shrink_memory": 0,
                        "grow_lanes": 0, "shrink_lanes": 0}
        self.log: list[Decision] = []

    # -- trigger predicates (pure, per-window) --------------------------

    def _memory_pressure(self, m: WindowMetrics) -> bool:
        churning = (m.evictions_per_op > self.cfg.evict_pressure
                    or m.insert_drops_per_op > self.cfg.evict_pressure)
        return m.hit_rate < self.cfg.hit_rate_floor and churning

    def _memory_surplus(self, m: WindowMetrics) -> bool:
        comfortable = m.hit_rate > (self.cfg.hit_rate_floor
                                    + self.cfg.hit_rate_slack)
        # Occupancy is byte-accurate when the window reports blocks: an
        # over-provisioned pool is one whose *bytes* sit idle.
        idle = (m.evictions_per_op <= self.cfg.evict_pressure
                and m.occupancy < self.cfg.occupancy_low)
        return comfortable and idle

    def _util(self, m: WindowMetrics) -> Optional[float]:
        if m.offered_mops is None or m.tput_mops <= 0:
            return None
        return m.offered_mops / m.tput_mops

    # -- main entry -----------------------------------------------------

    def observe(self, m: WindowMetrics) -> Decision:
        d = self._decide(m)
        self.log.append(d)
        return d

    def _decide(self, m: WindowMetrics) -> Decision:
        if self._cooldown > 0:
            self._cooldown -= 1
            return NONE

        u = self._util(m)
        triggers = {
            "grow_memory": self._memory_pressure(m),
            "shrink_memory": self._memory_surplus(m),
            "grow_lanes": u is not None and u > self.cfg.util_high,
            "shrink_lanes": u is not None and u < self.cfg.util_low,
        }
        for k, on in triggers.items():
            self._streak[k] = self._streak[k] + 1 if on else 0

        c = self.cfg
        # Memory targets are denominated in whatever unit the window
        # reports: 64B blocks when byte occupancy is available (the
        # elastic runtime's native unit), live objects otherwise.
        cap = m.capacity_blocks if m.capacity_blocks > 0 else m.capacity
        occ = m.blocks_cached if m.capacity_blocks > 0 else m.n_cached
        if self._streak["grow_memory"] >= c.patience:
            target = min(int(cap * c.mem_step), c.max_capacity)
            if target > cap:
                return self._act("grow_memory", target,
                                 f"hit_rate={m.hit_rate:.3f} under churn")
        if self._streak["shrink_memory"] >= c.patience:
            target = max(int(cap / c.mem_step), c.min_capacity, occ)
            if target < cap:
                return self._act("shrink_memory", target,
                                 f"occupancy={occ}/{cap}")
        if self._streak["grow_lanes"] >= c.patience:
            target = min(int(math.ceil(m.lanes * c.lane_step)), c.max_lanes)
            if target > m.lanes:
                return self._act("grow_lanes", target, f"util={u:.2f}")
        if self._streak["shrink_lanes"] >= c.patience:
            target = max(int(m.lanes / c.lane_step), c.min_lanes)
            if target < m.lanes:
                return self._act("shrink_lanes", target, f"util={u:.2f}")
        return NONE

    def _act(self, action: str, target: int, reason: str) -> Decision:
        self._cooldown = self.cfg.cooldown
        for k in self._streak:
            self._streak[k] = 0
        return Decision(action, target, reason)


# ----------------------------------------------------------------------
# Online pipeline-width adaptation (DESIGN.md §13).
# ----------------------------------------------------------------------

class WidthController:
    """Hysteretic hill-climb over the DM pipeline chunk width.

    The scenario driver dispatches the trace to ``dm_execute`` in chunks
    of ``width`` rounds (one compiled scan per chunk; chunking is
    execution-only — results are bit-equal at any width).  Each warm
    chunk's measured wall time feeds the same linear cost model the
    trace planner uses (``us_per_chunk(w) ~ alpha + beta*w``, so the
    per-round cost ``alpha/w + beta`` falls as dispatch overhead
    amortizes), and at every window boundary the controller climbs one
    step toward the width the model predicts cheapest per round.

    Stability mirrors the Autoscaler: moves are single steps on the
    width ladder, need a ``patience`` streak of windows agreeing, and
    must beat the current width by a ``margin`` factor — measurement
    noise cannot make the width oscillate."""

    def __init__(self, widths=(1, 2, 4, 8, 16, 32),
                 model: Optional[PlanCostModel] = None,
                 margin: float = 1.10, patience: int = 2,
                 start: Optional[int] = None):
        assert len(widths) > 0 and margin >= 1.0 and patience >= 1
        self.widths = sorted(set(int(w) for w in widths))
        self.model = model if model is not None else PlanCostModel()
        self.margin = margin
        self.patience = patience
        self._i = (self.widths.index(start) if start in self.widths
                   else len(self.widths) // 2)
        self._streak = 0
        self.log: list = []

    @property
    def width(self) -> int:
        return self.widths[self._i]

    def observe_chunk(self, n_rounds: int, wall_s: float) -> None:
        """Record one WARM chunk's wall time (callers must skip the
        compile call of each chunk shape — a compile would dwarf the
        signal and freeze the controller)."""
        if n_rounds > 0 and wall_s > 0:
            self.model.observe(n_rounds, wall_s * 1e6)

    def _per_round(self, w: int) -> float:
        return self.model.us_per_step(w) / w

    def propose(self) -> int:
        """Window-boundary decision: the width to use next."""
        cur = self._per_round(self.width)
        lo = max(0, self._i - 1)
        hi = min(len(self.widths) - 1, self._i + 1)
        best = min(range(lo, hi + 1), key=lambda i:
                   self._per_round(self.widths[i]))
        if best != self._i and cur > self.margin * self._per_round(
                self.widths[best]):
            self._streak += 1
            if self._streak >= self.patience:
                self._i = best
                self._streak = 0
                self.log.append(self.width)
        else:
            self._streak = 0
        return self.width


# ----------------------------------------------------------------------
# Multi-tenant budget arbitration (DESIGN.md §11).
# ----------------------------------------------------------------------

class TenantWindow(NamedTuple):
    """One tenant's view of an observation window."""

    occupancy_blocks: int        # live blocks the tenant holds
    budget_blocks: int           # its current budget
    hit_rate: float              # canonical per-tenant hit ratio
    miss_blocks: float = 0.0     # bytes (blocks) fetched on its misses —
    #                            # the demand signal: unserved traffic


@dataclasses.dataclass
class TenantArbiterConfig:
    floor_frac: float = 0.5      # guaranteed fraction of the fair share
    #                            # (total/T) every tenant always keeps —
    #                            # demand can never starve a tenant below
    #                            # floor_frac * total / T blocks
    ema: float = 0.5             # demand smoothing (1.0 = last window)
    min_change_frac: float = 0.05  # re-split only when some tenant's
    #                            # budget would move by more than this
    #                            # fraction of the fair share (hysteresis)

    def __post_init__(self):
        assert 0.0 <= self.floor_frac <= 1.0
        assert 0.0 < self.ema <= 1.0


class TenantArbiter:
    """Arbitrates the global byte budget across tenants.

    Deterministic floor + demand-proportional split: every tenant keeps
    a guaranteed floor (``floor_frac`` of the fair share), and the
    remaining blocks split proportionally to a smoothed demand signal —
    miss bytes (traffic the tenant's current budget failed to serve)
    plus its live occupancy (what it proved it can use). A flash-crowd
    tenant therefore *earns* budget from idle tenants without ever
    pushing an active tenant below its floor; the hysteresis band keeps
    a steady mix from oscillating."""

    def __init__(self, cfg: Optional[TenantArbiterConfig] = None):
        self.cfg = cfg or TenantArbiterConfig()
        self._demand: Optional[list] = None
        self.log: list = []

    def propose(self, total_blocks: int,
                windows: "list[TenantWindow]") -> Optional[tuple]:
        """New per-tenant budgets summing to ``total_blocks``, or None
        when the current split is within the hysteresis band."""
        t = len(windows)
        if t == 0:
            return None
        raw = [max(float(w.miss_blocks), 0.0)
               + max(int(w.occupancy_blocks), 0) for w in windows]
        if self._demand is None or len(self._demand) != t:
            self._demand = raw
        else:
            a = self.cfg.ema
            self._demand = [a * r + (1 - a) * d
                            for r, d in zip(raw, self._demand)]
        fair = total_blocks // t
        floor = max(1, int(fair * self.cfg.floor_frac))
        spare = total_blocks - floor * t
        dsum = sum(self._demand)
        if dsum <= 0:
            shares = [spare // t] * t
        else:
            shares = [int(spare * d / dsum) for d in self._demand]
        budgets = [floor + s for s in shares]
        # Hand leftover rounding blocks to the hungriest tenants.
        rest = total_blocks - sum(budgets)
        order = sorted(range(t), key=lambda i: -self._demand[i])
        for i in range(rest):
            budgets[order[i % t]] += 1
        budgets = tuple(budgets)
        cur = tuple(int(w.budget_blocks) for w in windows)
        band = max(1, int(fair * self.cfg.min_change_frac))
        if all(abs(b - c) <= band for b, c in zip(budgets, cur)):
            return None
        self.log.append(budgets)
        return budgets


# ----------------------------------------------------------------------
# Shard health: heartbeat / missed-beat failure detection (DESIGN.md §14).
# ----------------------------------------------------------------------

@dataclasses.dataclass
class HealthConfig:
    """Detection hysteresis, in observation windows.  One missed beat is
    noise (a slow window, a stalled collective); ``miss_threshold``
    consecutive misses declare the shard dead — the same patience-streak
    shape the Autoscaler uses for scale triggers."""

    miss_threshold: int = 2       # consecutive missed beats → failed
    beat_threshold: int = 1       # consecutive beats from a failed
    #                             # shard → recovered (replacement up)

    def __post_init__(self):
        if self.miss_threshold < 1 or self.beat_threshold < 1:
            raise ValueError("health thresholds must be >= 1 window")


class HealthMonitor:
    """Per-shard heartbeat state machine: alive → (missed beats x
    patience) → failed → (beats x patience) → alive.

    The monitor only *detects*; acting on a transition — re-routing via
    ``Cluster.mark_failed``, rewarming via ``Cluster.recover`` — is the
    scenario driver's job, so detection latency (the windows between a
    ground-truth failure and its ``newly_failed`` report) is visible in
    the measured timeline rather than hidden inside the router."""

    def __init__(self, n_shards: int,
                 cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self.n_shards = n_shards
        self._missed = [0] * n_shards
        self._beats = [0] * n_shards
        self._failed = [False] * n_shards
        self.log: list[tuple[int, str]] = []   # (shard, "failed"|"recovered")

    @property
    def failed(self) -> tuple[bool, ...]:
        """Current detected-failed view (what routing should avoid)."""
        return tuple(self._failed)

    def observe(self, beats) -> tuple[list[int], list[int]]:
        """Feed one window of heartbeats (``beats[k]`` True iff shard k
        responded).  Returns (newly_failed, newly_recovered) shard ids —
        each transition is reported exactly once."""
        beats = list(beats)
        assert len(beats) == self.n_shards
        newly_failed: list[int] = []
        newly_recovered: list[int] = []
        for k, beat in enumerate(beats):
            if beat:
                self._missed[k] = 0
                self._beats[k] += 1
                if (self._failed[k]
                        and self._beats[k] >= self.cfg.beat_threshold):
                    self._failed[k] = False
                    newly_recovered.append(k)
                    self.log.append((k, "recovered"))
            else:
                self._beats[k] = 0
                self._missed[k] += 1
                if (not self._failed[k]
                        and self._missed[k] >= self.cfg.miss_threshold):
                    self._failed[k] = True
                    newly_failed.append(k)
                    self.log.append((k, "failed"))
        return newly_failed, newly_recovered
