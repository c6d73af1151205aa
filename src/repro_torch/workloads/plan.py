"""Trace planner: pack request streams into bucket-disjoint groups.

``core/cache.py`` retires one trace row per step.  The paper's
client-centric framework gets its throughput from issuing *independent*
remote accesses concurrently (one-RTT batched pipeline, §4.1); requests
that touch disjoint hash buckets are commutative — executing them in one
batched step cannot change any caching decision relative to executing
them round by round.  The planner makes that structure explicit:

  * A **group** is a ``[G, C]`` block of requests (G rounds x C client
    lanes) executed by ``core.cache.access_group`` as ONE step.
  * **Grouping invariant** (``scope="strict"``): within a group, any hash
    bucket is touched by at most one round.  Rounds of a group therefore
    commute — a round's probe / hit-metadata update / insert can never
    observe another round's effects — which is exactly the condition
    under which batched execution is decision-equivalent to executing
    the rounds sequentially (see DESIGN.md §9 and tests/test_batched.py).
  * ``scope="lane"`` relaxes the invariant to per-lane bucket
    disjointness, and further allows a lane to revisit a bucket across
    rounds when every op involved is a GET (read-read reuse: repeated
    reads of a hot object combine within the step, the same
    write-combining the paper's FC cache applies to freq updates).
    Cross-lane same-bucket races across rounds resolve with the
    engine's ordinary within-step combine semantics — the same races
    concurrent client threads already exhibit — trading exact
    round-sequential equivalence for much denser packing on skewed
    (zipfian) traces, where one hot key can dominate a lane's stream.

Per-lane, per-KEY program order is always preserved: a lane's requests
for the same key are scheduled in their original order (a client's own
read-after-write is never reordered).  Requests to *different* keys may
be reordered within a bounded ``lookahead`` window — the analogue of a
client issuing independent requests concurrently.

All planning is host-side numpy; the emitted ``GroupPlan`` arrays are
static-shaped and feed the step loop of ``core/cache.py`` group by group.

This is the port's own copy of ``repro/workloads/plan.py`` (the port
imports nothing of the JAX package); the same inputs give the same
plans.  The planner's ``validate`` option, which runs the JAX package's
invariant sanitizer, is not carried over: the sanitizer is a later item
of the port.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class GroupPlan(NamedTuple):
    """A planned batched schedule for a [T, C] trace.

    Array fields are [n_groups, batch, C]; key 0 / src_t -1 mark padding
    (unfilled lane-round slots).
    """

    keys: np.ndarray        # u32[NG, G, C]
    is_write: np.ndarray    # bool[NG, G, C]
    sizes: np.ndarray       # u32[NG, G, C]
    src_t: np.ndarray       # i32[NG, G, C] original trace row, -1 = pad
    batch: int              # G, rounds per group
    scope: str              # "strict" | "lane"
    tenants: Optional[np.ndarray] = None  # u32[NG, G, C] tenant ids
    #                       # (None for single-tenant plans)

    @property
    def n_groups(self) -> int:
        return self.keys.shape[0]

    @property
    def n_scheduled(self) -> int:
        return int((self.src_t >= 0).sum())

    @property
    def fill(self) -> float:
        """Fraction of lane-round slots holding a real request."""
        return self.n_scheduled / max(self.src_t.size, 1)

    @property
    def rows_per_group(self) -> float:
        """Effective original-trace rows retired per group (C requests
        ~= one row); the scan-step compression factor of the plan."""
        c = self.keys.shape[2]
        return self.n_scheduled / max(self.n_groups * c, 1)

    def rounds(self):
        """The planned schedule flattened to a [NG*G, C] round-per-step
        trace — the *sequential baseline* of the decision-equivalence
        contract: running this through the one-round engine must match
        running the grouped plan through the batched engine."""
        ng, g, c = self.keys.shape
        return (self.keys.reshape(ng * g, c),
                self.is_write.reshape(ng * g, c),
                self.sizes.reshape(ng * g, c))


def _buckets_of(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """Host-side mirror of core/hashing.py: splitmix32 -> bucket."""
    x = keys.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x + np.uint32(0x9E3779B9)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(n_buckets)).astype(np.int64)


def plan_groups(keys: np.ndarray, n_buckets: int, batch: int, *,
                scope: str = "strict",
                is_write: Optional[np.ndarray] = None,
                sizes: Optional[np.ndarray] = None,
                tenants: Optional[np.ndarray] = None,
                lookahead: Optional[int] = None) -> GroupPlan:
    """Greedily pack a [T, C] trace into bucket-disjoint [G, C] groups.

    Args:
      keys: u32[T, C] request tensor (0 = no-op pad, skipped).
      n_buckets: the cache's bucket count (defines conflict classes).
      batch: G, rounds per group (the batch width knob).
      scope: "strict" — a bucket appears in at most one round per group
        (global, the commutativity invariant); "lane" — per-lane bucket
        disjointness with read-read reuse (denser packing, concurrent
        cross-lane races and within-lane read combining).
      is_write / sizes / tenants: optional [T, C] op tensors carried
        through (tenants: per-request tenant ids, DESIGN.md §11).
      lookahead: how far past a blocked request a lane may schedule
        ahead (default 4*batch).  Blocked requests and all later
        requests to the same key park until the next group.
    Returns:
      GroupPlan; every non-pad request of `keys` appears exactly once.
    """
    if scope not in ("strict", "lane"):
        raise ValueError(f"unknown plan scope {scope!r}")
    keys = np.asarray(keys, np.uint32)
    T, C = keys.shape
    if is_write is None:
        is_write = np.zeros((T, C), bool)
    if sizes is None:
        sizes = np.ones((T, C), np.uint32)
    carry_tenants = tenants is not None
    if tenants is None:
        tenants = np.zeros((T, C), np.uint32)
    look = max(4 * batch, 16) if lookahead is None else max(1, int(lookahead))
    bucket = _buckets_of(keys, n_buckets)

    # Per-lane remaining request rows, in program order.
    rem = [[t for t in range(T) if keys[t, c] != 0] for c in range(C)]

    g_keys, g_wr, g_sz, g_tn, g_src = [], [], [], [], []
    while any(rem):
        gk = np.zeros((batch, C), np.uint32)
        gw = np.zeros((batch, C), bool)
        gs = np.ones((batch, C), np.uint32)
        gn = np.zeros((batch, C), np.uint32)
        gt = np.full((batch, C), -1, np.int64)
        bucket_round = {}                      # strict: bucket -> round
        # lane scope: bucket -> True if any scheduled op on it wrote
        lane_buckets = [dict() for _ in range(C)]
        parked = [set() for _ in range(C)]     # keys parked this group
        window = [rem[c][:look] for c in range(C)]
        taken = [set() for _ in range(C)]      # window positions scheduled
        for r in range(batch):
            for c in range(C):
                for j, t in enumerate(window[c]):
                    if j in taken[c]:
                        continue
                    k = int(keys[t, c])
                    if k in parked[c]:
                        continue
                    b = int(bucket[t, c])
                    wr = bool(is_write[t, c])
                    if scope == "strict":
                        ok = bucket_round.get(b, r) == r
                    else:
                        # Reuse of a lane's own bucket across rounds is
                        # allowed only when every op involved is a read.
                        seen = lane_buckets[c].get(b)
                        ok = seen is None or not (seen or wr)
                    if not ok:
                        # Blocked for the rest of the group (the bucket is
                        # owned by an earlier round); park the key so later
                        # same-key requests cannot overtake program order.
                        parked[c].add(k)
                        continue
                    if scope == "strict":
                        bucket_round[b] = r
                    lane_buckets[c][b] = bool(lane_buckets[c].get(b)) or wr
                    gk[r, c] = keys[t, c]
                    gw[r, c] = is_write[t, c]
                    gs[r, c] = sizes[t, c]
                    gn[r, c] = tenants[t, c]
                    gt[r, c] = t
                    taken[c].add(j)
                    break
        for c in range(C):
            done = {window[c][j] for j in taken[c]}
            rem[c] = [t for t in rem[c] if t not in done]
        g_keys.append(gk)
        g_wr.append(gw)
        g_sz.append(gs)
        g_tn.append(gn)
        g_src.append(gt)

    if not g_keys:  # empty trace
        g_keys = [np.zeros((batch, C), np.uint32)]
        g_wr = [np.zeros((batch, C), bool)]
        g_sz = [np.ones((batch, C), np.uint32)]
        g_tn = [np.zeros((batch, C), np.uint32)]
        g_src = [np.full((batch, C), -1, np.int64)]
    return GroupPlan(np.stack(g_keys), np.stack(g_wr), np.stack(g_sz),
                     np.stack(g_src).astype(np.int32), batch, scope,
                     np.stack(g_tn) if carry_tenants else None)


# ---------------------------------------------------------------------------
# Width-adaptive planning (DESIGN.md §13).
#
# The greedy packer above reorders requests through a lookahead window —
# good packing, but O(T * batch * lookahead) python and therefore the
# 0.6 s `plan_s` the throughput benchmark measured at width 128.  The
# adaptive path below never reorders: it cuts the trace into maximal
# CONSECUTIVE row chunks that satisfy the lane-scope invariant (a lane
# may not revisit a bucket inside a chunk unless every op involved is a
# GET), which reduces all planning to one vectorized conflict scan plus
# an O(T) chunk walk.  Program order is preserved trivially, and a width
# is chosen per window from a calibrated step-cost model plus an
# estimate of the hit-rate loss wide snapshots cost.
# ---------------------------------------------------------------------------


def _conflict_limits(keys: np.ndarray, n_buckets: int,
                     is_write: np.ndarray) -> np.ndarray:
    """i64[T]: for each trace row t, the latest earlier row t' where the
    same lane touches the same bucket with a write on either side (-1 if
    none).  A consecutive chunk [s, e) satisfies the lane-scope packing
    invariant iff ``limit[t] < s`` for every row t in the chunk.

    One lexsort by (lane, bucket, row) turns the per-(lane, bucket)
    conflict chains into contiguous runs; the last-write-before-me is a
    segmented running max (offset trick), so the whole scan is O(B log B)
    numpy with no python per-request loop."""
    T, C = keys.shape
    limit = np.full(T, -1, np.int64)
    mask = keys != 0
    if not mask.any():
        return limit
    t_idx, c_idx = np.nonzero(mask)
    bb = _buckets_of(keys, n_buckets)[t_idx, c_idx]
    ww = np.asarray(is_write, bool)[t_idx, c_idx]
    order = np.lexsort((t_idx, bb, c_idx))
    ts = t_idx[order]
    ws = ww[order]
    same = np.zeros(len(order), bool)
    same[1:] = ((c_idx[order][1:] == c_idx[order][:-1])
                & (bb[order][1:] == bb[order][:-1]))
    # Latest same-(lane,bucket) predecessor of any kind: the previous
    # element of the run (rows are ascending within a run).
    prev_any = np.where(same, np.concatenate(([-1], ts[:-1])), -1)
    # Latest same-(lane,bucket) WRITE predecessor: segmented running max
    # of write rows, shifted by one so an op never conflicts with itself.
    run_id = np.cumsum(~same) - 1
    shifted = np.concatenate(([-1], np.where(ws, ts, -1)[:-1]))
    shifted[~same] = -1
    off = np.int64(T + 1)
    prev_write = np.maximum.accumulate(shifted + run_id * off) - run_id * off
    # A write conflicts with any predecessor; a read only with writes.
    conf = np.where(ws, prev_any, prev_write)
    np.maximum.at(limit, ts, conf)
    return limit


def _chunk_bounds(limit: np.ndarray, start: int, stop: int,
                  batch: int) -> list:
    """Greedy maximal consecutive chunking of rows [start, stop): each
    chunk holds <= batch rows and is conflict-free under `limit`."""
    bounds = []
    s = start
    for t in range(start, stop):
        if t == s:
            continue
        if t - s >= batch or limit[t] >= s:
            bounds.append((s, t))
            s = t
    if stop > start:
        bounds.append((s, stop))
    return bounds


def pack_rows(keys: np.ndarray, n_buckets: int, batch: int, *,
              is_write: Optional[np.ndarray] = None,
              sizes: Optional[np.ndarray] = None,
              tenants: Optional[np.ndarray] = None,
              start: int = 0, stop: Optional[int] = None,
              limit: Optional[np.ndarray] = None) -> GroupPlan:
    """Pack a [T, C] trace into lane-scope groups WITHOUT reordering.

    Rows are cut into maximal consecutive chunks of <= ``batch`` rows
    such that no lane revisits a bucket within a chunk with a write
    involved (read-read reuse allowed, exactly ``plan_groups``'s
    scope="lane" rule); each chunk becomes one [batch, C] group with its
    rows as the leading rounds.  Per-key program order is preserved by
    construction, and planning is one vectorized conflict scan + an O(T)
    walk — the fast path behind :func:`plan_adaptive`.

    ``start``/``stop`` restrict packing to a row range (used by the
    segment planner); ``limit`` injects a precomputed
    :func:`_conflict_limits` array to avoid rescanning per segment.
    """
    keys = np.asarray(keys, np.uint32)
    T, C = keys.shape
    stop = T if stop is None else stop
    if is_write is None:
        is_write = np.zeros((T, C), bool)
    if sizes is None:
        sizes = np.ones((T, C), np.uint32)
    carry_tenants = tenants is not None
    if tenants is None:
        tenants = np.zeros((T, C), np.uint32)
    if limit is None:
        limit = _conflict_limits(keys, n_buckets, is_write)
    bounds = _chunk_bounds(limit, start, stop, batch)
    ng = max(len(bounds), 1)
    gk = np.zeros((ng, batch, C), np.uint32)
    gw = np.zeros((ng, batch, C), bool)
    gs = np.ones((ng, batch, C), np.uint32)
    gn = np.zeros((ng, batch, C), np.uint32)
    gt = np.full((ng, batch, C), -1, np.int32)
    for i, (s, e) in enumerate(bounds):
        n = e - s
        gk[i, :n] = keys[s:e]
        gw[i, :n] = is_write[s:e]
        gs[i, :n] = sizes[s:e]
        gn[i, :n] = tenants[s:e]
        gt[i, :n] = np.where(keys[s:e] != 0,
                             np.arange(s, e, dtype=np.int32)[:, None], -1)
    return GroupPlan(gk, gw, gs, gt, batch, "lane",
                     gn if carry_tenants else None)


class PlanCostModel:
    """Linear model of one batched scan step: us_per_step(G) ~ alpha +
    beta * G.  Defaults are calibrated on the CPU interpreter at C=16
    (BENCH_throughput.json: sequential ~180 us/step, width-32 groups
    ~1.7 ms/step); ``observe`` folds measured step times back in, so the
    elastic runtime's width controller adapts the model online the same
    way expert weights adapt the eviction policy."""

    def __init__(self, alpha: float = 130.0, beta: float = 50.0):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._obs: dict = {}    # width -> recent us_per_step samples
        self._eff: dict = {}    # width -> EMA packing efficiency

    def _estimates(self) -> dict:
        """Per-width point estimates: the MEDIAN of recent samples.

        Host walls on a shared box swing +-15% per run, one-sided.  A
        running minimum is biased by sample count (a width that executes
        as five small segments per run draws five lottery tickets to the
        sequential baseline's one), and an EMA mixes each width's
        estimate with a different noise realization; the median is fair
        regardless of how many segments a schedule splits a width into.
        """
        return {w: float(np.median(v)) for w, v in self._obs.items()}

    def us_per_step(self, width: int) -> float:
        est = self._estimates()
        # A direct observation is ground truth for its width; the linear
        # fit only interpolates UNOBSERVED widths.  (The fit through a
        # convex ladder over-estimates the sequential endpoint, which
        # would make marginal widths look profitable when the measured
        # G=1 cost says otherwise — exactly the YCSB-A failure mode.)
        hit = est.get(int(width))
        if hit is not None:
            return hit
        if len(est) >= 2:
            ws = np.array(sorted(est), float)
            ys = np.array([est[w] for w in sorted(est)], float)
            a_mat = np.stack([np.ones_like(ws), ws], axis=1)
            coef, *_ = np.linalg.lstsq(a_mat, ys, rcond=None)
            a, b = max(float(coef[0]), 1.0), max(float(coef[1]), 0.0)
            return a + b * width
        if len(est) == 1:
            (w0, y0), = est.items()
            scale = y0 / (self.alpha + self.beta * w0)
            return scale * (self.alpha + self.beta * width)
        return self.alpha + self.beta * width

    def observe(self, width: int, us_per_step: float,
                decay: float = 0.3, eff: Optional[float] = None) -> None:
        """Fold one measured step time (and optionally the packing
        efficiency that produced it) into the model; the last 64
        samples per width are kept and summarized by their median."""
        width = int(width)
        self._obs.setdefault(width, []).append(float(us_per_step))
        del self._obs[width][:-64]
        if eff is not None:
            old_e = self._eff.get(width)
            self._eff[width] = (eff if old_e is None
                                else (1 - decay) * old_e + decay * eff)

    def efficiency(self, width: int) -> float:
        """Packing-efficiency bound for ``width``: rows / (steps * G).

        Measured EMA when this width has executed; for an unobserved
        width, the worst efficiency seen at any narrower width (short
        conflict runs that starve narrow groups starve wide ones more);
        optimistically 1.0 with no data at all — the prune stays
        permissive until real executions say otherwise."""
        hit = self._eff.get(int(width))
        if hit is not None:
            return max(float(hit), 1e-3)
        below = [v for w, v in self._eff.items() if w <= width]
        return max(min(below, default=1.0), 1e-3)


class Segment(NamedTuple):
    """One contiguous row range of an adaptive schedule."""

    start: int                     # first trace row
    stop: int                      # one past the last row
    width: int                     # chosen G (1 = sequential rows)
    plan: Optional[GroupPlan]      # packed groups when width > 1


class SegmentSchedule(NamedTuple):
    """The adaptive planner's output: per-window widths materialized as
    contiguous execution segments (see ``core/execute.py``)."""

    segments: Tuple[Segment, ...]
    widths: np.ndarray             # i32[n_windows] chosen width per window
    window: int                    # rows per decision window
    plan_s: float                  # host planning wall time (seconds)

    @property
    def n_rows(self) -> int:
        return sum(s.stop - s.start for s in self.segments)

    @property
    def max_width(self) -> int:
        return max((s.width for s in self.segments), default=1)

    @property
    def fill(self) -> float:
        """Slot utilization over the grouped segments (1.0 when the
        whole schedule runs sequentially — every row is full by
        definition there)."""
        slots = reqs = 0
        for s in self.segments:
            if s.plan is not None:
                slots += s.plan.keys.size
                reqs += s.plan.n_scheduled
        return reqs / slots if slots else 1.0


def _repeat_stats(keys: np.ndarray, capacity: Optional[int]):
    """Per-request hit-loss ingredients, all in flat (row-major) order:
    row index, previous-occurrence row distance of the same key, and a
    "cold" flag (first occurrence, or reuse distance beyond the cache's
    plausible reach — such a request would miss sequentially too)."""
    T, C = keys.shape
    mask = keys.reshape(-1) != 0
    flat_t = np.repeat(np.arange(T, dtype=np.int64), C)[mask]
    kk = keys.reshape(-1)[mask]
    order = np.argsort(kk, kind="stable")
    ts = flat_t[order]
    same = np.zeros(len(order), bool)
    same[1:] = kk[order][1:] == kk[order][:-1]
    prev_t = np.where(same, np.concatenate(([0], ts[:-1])), -1)
    d_rows = np.where(same, ts - prev_t, np.int64(1 << 40))
    horizon = np.int64(1 << 40) if capacity is None \
        else max(np.int64(4 * capacity) // max(C, 1), 1)
    cold = d_rows > horizon
    # prev_cold[i]: was the previous occurrence of i's key itself cold?
    prev_cold = np.concatenate(([True], cold[:-1]))
    prev_cold[~same] = True
    # back to flat order
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return flat_t, d_rows[inv], cold[inv], prev_cold[inv]


def _bucket_collision_dist(keys: np.ndarray, n_buckets: int,
                           flat_t: np.ndarray,
                           cold: np.ndarray) -> np.ndarray:
    """Row distance from each cold request to the previous cold request
    on the same bucket (any lane) — the `_first_winner` insert-dedup
    hazard: two cold inserts landing on one bucket in the same step drop
    one of them."""
    mask = keys.reshape(-1) != 0
    bb = _buckets_of(keys, n_buckets).reshape(-1)[mask]
    d = np.full(len(flat_t), np.int64(1 << 40))
    ci = np.nonzero(cold)[0]
    if len(ci) < 2:
        return d
    order = np.lexsort((flat_t[ci], bb[ci]))
    ts = flat_t[ci][order]
    same = np.zeros(len(order), bool)
    same[1:] = bb[ci][order][1:] == bb[ci][order][:-1]
    prev_t = np.where(same, np.concatenate(([0], ts[:-1])), -1)
    dd = np.where(same, ts - prev_t, np.int64(1 << 40))
    out = np.empty(len(ci), np.int64)
    out[order] = dd
    d[ci] = out
    return d


def plan_adaptive(keys: np.ndarray, n_buckets: int, max_batch: int, *,
                  is_write: Optional[np.ndarray] = None,
                  sizes: Optional[np.ndarray] = None,
                  tenants: Optional[np.ndarray] = None,
                  window: int = 0,
                  widths: Optional[Sequence] = None,
                  model: Optional[PlanCostModel] = None,
                  hr_budget: float = 0.02,
                  capacity: Optional[int] = None,
                  min_gain: float = 1.4) -> SegmentSchedule:
    """Pick a group width per window and materialize the schedule.

    Decision rule (DESIGN.md §13), per window of ``window`` rows: for
    each candidate width G the real chunk walk gives NG(G) scan steps,
    so the predicted window cost is ``NG(G) * model.us_per_step(G)``;
    the predicted hit-rate loss of executing the window at width G is

        loss(G) ~= P[repeat whose prior occurrence was a MISS lands in
                     the same chunk (its insert is invisible)]
                 + P[two cold inserts collide on one bucket in a chunk
                     (`_first_winner` drops one)] * P[key repeats]

    both computed from reuse distances against the average chunk length.
    The cheapest candidate with loss(G) <= ``hr_budget`` wins, and must
    beat sequential by ``min_gain`` — otherwise the window degenerates
    to G=1 (as on write-heavy YCSB-A where packing collapses), which is
    executed as raw rows with zero packing overhead.

    ``min_gain`` is deliberately far above 1: host timings on a shared
    box carry several percent of noise per sample, so a predicted win
    inside that band is as likely a sampling artifact as a real one —
    and acting on it costs real planning time and schedule churn.  A
    width has to promise a win comfortably outside the noise floor
    before the planner abandons the (always-safe) sequential fallback.
    """
    t0 = time.perf_counter()
    keys = np.asarray(keys, np.uint32)
    T, C = keys.shape
    if is_write is None:
        is_write = np.zeros((T, C), bool)
    if model is None:
        model = PlanCostModel()
    max_batch = max(int(max_batch), 1)
    if widths is None:
        widths = [w for w in (2, 4, 8, 16, 32, 64, 128, 256)
                  if w <= max_batch]
        if max_batch > 1 and max_batch not in widths:
            widths.append(max_batch)
    widths = sorted({int(w) for w in widths if 1 < int(w) <= max_batch})
    if window <= 0:
        window = min(max(64, 2 * max_batch), max(T, 1))

    # Optimistic prune: under the best packing this model has ever seen
    # (efficiency(g), 1.0 when unobserved) a width only wins if
    # us_per_step(g)/(g*eff) beats sequential by min_gain.
    # With a calibrated model a degenerate workload (write-heavy YCSB-A)
    # fails this bound for every candidate and the whole trace falls
    # back to sequential WITHOUT paying for conflict analysis — the
    # G=1 fallback costs microseconds to plan, so the amortized
    # adaptive number can never lose to sequential by more than noise.
    seq_us = model.us_per_step(1)
    widths = [g for g in widths
              if model.us_per_step(g) / (g * model.efficiency(g))
              * min_gain <= seq_us]

    if T == 0 or not widths:
        return SegmentSchedule((Segment(0, T, 1, None),) if T else (),
                               np.ones(0, np.int32), window,
                               time.perf_counter() - t0)

    limit = _conflict_limits(keys, n_buckets, is_write)
    flat_t, d_key, cold, prev_cold = _repeat_stats(keys, capacity)
    d_coll = _bucket_collision_dist(keys, n_buckets, flat_t, cold)
    warm_frac = float(np.mean(~cold)) if len(cold) else 0.0

    n_windows = -(-T // window)
    chosen = np.ones(n_windows, np.int32)
    for wi in range(n_windows):
        a, b = wi * window, min((wi + 1) * window, T)
        rows = b - a
        in_w = (flat_t >= a) & (flat_t < b)
        n_req = max(int(in_w.sum()), 1)
        best_w, best_cost = 1, rows * model.us_per_step(1)
        for g in widths:
            ng = len(_chunk_bounds(limit, a, b, g))
            if ng == 0:
                continue
            avg_len = rows / ng
            # Probability a predecessor at row distance d shares the
            # chunk: ~ max(0, 1 - d / avg_len) for uniform chunk phase.
            p_rep = np.maximum(0.0, 1.0 - d_key[in_w] / avg_len)
            lost_rep = float(np.sum(p_rep * prev_cold[in_w] * ~cold[in_w]))
            p_coll = np.maximum(0.0, 1.0 - d_coll[in_w] / avg_len)
            lost_coll = float(np.sum(p_coll * cold[in_w])) * warm_frac
            loss = (lost_rep + lost_coll) / n_req
            if loss > hr_budget:
                continue
            cost = ng * model.us_per_step(g)
            if cost < best_cost:
                best_w, best_cost = g, cost
        # The switch away from sequential must clear the min_gain margin.
        if best_w > 1 and best_cost * min_gain > rows * model.us_per_step(1):
            best_w = 1
        chosen[wi] = best_w

    segments = []
    wi = 0
    while wi < n_windows:
        wj = wi
        while wj + 1 < n_windows and chosen[wj + 1] == chosen[wi]:
            wj += 1
        a, b = wi * window, min((wj + 1) * window, T)
        g = int(chosen[wi])
        if g <= 1:
            segments.append(Segment(a, b, 1, None))
        else:
            plan = pack_rows(keys, n_buckets, g, is_write=is_write,
                             sizes=sizes, tenants=tenants, start=a, stop=b,
                             limit=limit)
            segments.append(Segment(a, b, g, plan))
        wi = wj + 1

    return SegmentSchedule(tuple(segments), chosen, window,
                           time.perf_counter() - t0)
