"""The runtime invariant sanitizer and the static plan checker.

A torch port of ``repro/analysis/sanitize.py``.  ``CacheConfig.sanitize
=True`` arms these checks at the end of ``core/cache.py::access_group_``
(both backends; they read the state the step produced):

  SAN001  ``bytes_cached`` == sum of live slot sizes and ``n_cached`` ==
          count of live slots.
  SAN002  ``tenant_bytes`` equals the per-tenant live-size sums and sums
          to ``bytes_cached``; a step never grows a tenant past its
          budget, nor the pool past ``capacity_blocks`` (occupancy above
          a freshly shrunken budget is legal, growing while over it is
          not).
  SAN003  no duplicate live key within a bucket.
  SAN004  expert-weight rows (global and per-lane) are non-negative and
          sum to 1 (within 1e-3).
  SAN005  live slots satisfy ``insert_ts <= last_ts <= clock``; the
          logical clock never runs backwards.
  SAN006  ``GroupPlan`` conflict freedom (host-side numpy, a plain copy
          of the JAX package's checker).

The JAX package functionalizes its checks with ``checkify`` and raises
the first failed one on exit.  Here every check is a boolean tensor, and
a step folds its checks into one i64 word: 0 while every check passed,
else the 1-based index into :data:`CHECKS` of the first check that
failed (in program order: the state's, the lanes', then the
transition's).  The word is a device tensor, so a step that carries it
issues no host sync and can be replayed as a CUDA graph:

* the trace drivers (``core/cache.py``'s ``_run_trace_impl`` and
  ``_run_trace_grouped_impl``, and ``dm/sharded_cache.py::dm_execute``)
  carry one word through their steps, keeping the first failure of the
  first failing step, and read it once after the segment, raising
  :class:`SanitizerError` that names the rule;
* a step called on its own (``access_group`` outside a driver) reads
  its word right after the step and raises there;
* :func:`checked` wraps any callable so that every word it makes is
  read only when it returns, the first failure raised then;
* a DM pool spread over ranks (``dm/ranks.py``) shares its words after
  every group (``dm/sharded_cache.py::_share_sync``), keeping the first
  failure of the first failing group by shard order, as one card
  carries it, so a violation on one rank raises the same
  :class:`SanitizerError` on all of them and no rank is left waiting in
  a collective.

``sanitize=False`` adds nothing to a step.  The timestamp checks assume
the u32 clock has not wrapped.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import (SIZE_EMPTY, SIZE_HISTORY, CacheConfig,
                                    CacheState, ClientState)

RULES: Dict[str, str] = {
    "SAN001": "bytes_cached/n_cached disagree with the live slots "
              "(byte-exactness drift)",
    "SAN002": "tenant accounting broken (column sums) or a step grew a "
              "tenant past its hard budget",
    "SAN003": "duplicate live key within a bucket",
    "SAN004": "expert-weight row off the simplex (negative or not "
              "summing to 1)",
    "SAN005": "timestamp order violated (insert_ts <= last_ts <= clock, "
              "clock monotone)",
    "SAN006": "GroupPlan conflict: bucket revisited across rounds "
              "(strict), write-write reuse (lane), or program order "
              "broken",
}

# Every runtime check, in program order; a word names one by its 1-based
# index here.
CHECKS = (
    ("SAN001", "SAN001: bytes_cached != sum of live slot sizes"),
    ("SAN001", "SAN001: n_cached != count of live slots"),
    ("SAN002", "SAN002: tenant_bytes != per-tenant live-size sums"),
    ("SAN002", "SAN002: sum(tenant_bytes) != bytes_cached"),
    ("SAN003", "SAN003: duplicate live key within a bucket"),
    ("SAN004", "SAN004: negative expert weight in state.weights"),
    ("SAN004", "SAN004: state.weights row does not sum to 1"),
    ("SAN005", "SAN005: live slot violates insert_ts <= last_ts <= clock"),
    ("SAN004", "SAN004: negative expert weight in local_weights"),
    ("SAN004", "SAN004: local_weights row does not sum to 1"),
    ("SAN005", "SAN005: logical clock ran backwards"),
    ("SAN002", "SAN002: step grew a tenant past its hard budget"),
    ("SAN002", "SAN002: step grew the pool past capacity_blocks"),
)

_SIMPLEX_TOL = 1e-3
I64 = torch.int64


class SanitizerError(AssertionError):
    """A runtime invariant check failed; the message starts with its rule
    id (``SAN001`` ... ``SAN005``)."""


class Word(NamedTuple):
    """The carry part of a sanitized trace driver: one i64 word."""
    word: torch.Tensor


def new_word(device) -> torch.Tensor:
    """A fresh word (no failure yet) on ``device``."""
    return torch.zeros((), dtype=I64, device=device)


def _want(rules: Optional[Sequence[str]], rid: str) -> bool:
    return rules is None or rid in rules


def _is_live(size: torch.Tensor) -> torch.Tensor:
    return (size != SIZE_EMPTY) & (size != SIZE_HISTORY)


def _on_simplex(w: torch.Tensor) -> tuple:
    return ((w < 0.0).any(),
            ~((w.sum(dim=-1) - 1.0).abs() < _SIMPLEX_TOL).all())


def state_failures(cfg: CacheConfig, state: CacheState, *,
                   rules: Optional[Sequence[str]] = None) -> list:
    """(check index, bool tensor: failed) for SAN001-SAN005 on one
    state, in program order."""
    live = _is_live(state.size)
    live_sizes = torch.where(live, state.size, 0)
    total = live_sizes.sum()
    out = []
    if _want(rules, "SAN001"):
        out += [(1, state.bytes_cached != total),
                (2, state.n_cached != live.sum())]
    if _want(rules, "SAN002"):
        if cfg.n_tenants > 1:
            per_t = torch.zeros((cfg.n_tenants,), dtype=I64,
                                device=live.device).index_add_(
                0, torch.where(live, state.tenant, 0), live_sizes)
        else:
            per_t = total[None]
        out += [(3, (state.tenant_bytes != per_t).any()),
                (4, state.tenant_bytes.sum() != state.bytes_cached)]
    if _want(rules, "SAN003"):
        k = state.key.reshape(cfg.n_buckets, cfg.assoc)
        lv = live.reshape(cfg.n_buckets, cfg.assoc)
        same = ((k[:, :, None] == k[:, None, :])
                & lv[:, :, None] & lv[:, None, :])
        eye = torch.eye(cfg.assoc, dtype=torch.bool, device=k.device)
        out.append((5, (same & ~eye[None]).any()))
    if _want(rules, "SAN004"):
        neg, off = _on_simplex(state.weights)
        out += [(6, neg), (7, off)]
    if _want(rules, "SAN005"):
        ok = ~live | ((state.insert_ts <= state.last_ts)
                      & (state.last_ts <= state.clock))
        out.append((8, ~ok.all()))
    return out


def clients_failures(cfg: CacheConfig, clients: ClientState, *,
                     rules: Optional[Sequence[str]] = None) -> list:
    """SAN004 for the per-lane local weight rows."""
    if not _want(rules, "SAN004"):
        return []
    neg, off = _on_simplex(clients.local_weights)
    return [(9, neg), (10, off)]


def step_failures(cfg: CacheConfig, old: CacheState, new: CacheState, *,
                  rules: Optional[Sequence[str]] = None) -> list:
    """Transition checks between consecutive states.  They read only the
    scalars of ``old`` (a step rebinds those; its table columns are
    written in place)."""
    out = []
    if _want(rules, "SAN005"):
        out.append((11, new.clock < old.clock))
    if _want(rules, "SAN002"):
        cap = torch.maximum(new.tenant_budget, old.tenant_bytes)
        gcap = torch.maximum(new.capacity_blocks, old.bytes_cached)
        out += [(12, (new.tenant_bytes > cap).any()),
                (13, new.bytes_cached > gcap)]
    return out


def first_failure(failures: list, device) -> torch.Tensor:
    """The word of a list of checks: the first failed one's index, or 0.
    Tensor ops only (no host sync)."""
    w = new_word(device)
    for cid, bad in reversed(failures):
        w = torch.where(bad, cid, w)
    return w


def step_word(cfg: CacheConfig, old: CacheState, new: CacheState,
              clients: ClientState) -> torch.Tensor:
    """The word of one step: the state it produced, its lanes, and the
    transition from ``old``."""
    return first_failure(state_failures(cfg, new)
                         + clients_failures(cfg, clients)
                         + step_failures(cfg, old, new), new.clock.device)


def merge_(word: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Keep ``word``'s failure if it has one, else take ``w``'s; in
    place."""
    return word.copy_(torch.where(word != 0, word, w))


# Active `checked` calls, innermost last: each collects the words its
# callable reports instead of reading them at once.
_SINKS: List[list] = []


def raise_word(word) -> None:
    """Read ``word`` (a host sync) and raise its failure, if any."""
    code = int(word)
    if code:
        raise SanitizerError(CHECKS[code - 1][1])


def report(word: torch.Tensor) -> None:
    """Raise ``word``'s failure now, or, inside :func:`checked`, when the
    wrapped callable returns."""
    if _SINKS:
        _SINKS[-1].append(word)
    else:
        raise_word(word)


def _report_failures(failures: list, device) -> None:
    report(first_failure(failures, device))


def check_state(cfg: CacheConfig, state: CacheState, *,
                rules: Optional[Sequence[str]] = None) -> None:
    """SAN001-SAN005 on one state; raises (or, inside :func:`checked`,
    defers) the first failure.  ``rules`` filters to a subset of ids."""
    _report_failures(state_failures(cfg, state, rules=rules),
                     state.size.device)


def check_clients(cfg: CacheConfig, clients: ClientState, *,
                  rules: Optional[Sequence[str]] = None) -> None:
    """SAN004 for the per-lane local weight rows."""
    _report_failures(clients_failures(cfg, clients, rules=rules),
                     clients.local_weights.device)


def check_step(cfg: CacheConfig, old: CacheState, new: CacheState, *,
               rules: Optional[Sequence[str]] = None) -> None:
    """Transition checks between consecutive states."""
    _report_failures(step_failures(cfg, old, new, rules=rules),
                     new.clock.device)


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that the checks it runs are read only when it
    returns: the first failure then raises :class:`SanitizerError`, as
    the JAX package's ``checked`` re-raises a functionalized check."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        sink: list = []
        _SINKS.append(sink)
        try:
            out = fn(*args, **kwargs)
        finally:
            _SINKS.pop()
        for word in sink:
            raise_word(word)
        return out

    return wrapper


# ---------------------------------------------------------------------------
# SAN006: the static GroupPlan conflict checker (host-side numpy).
# ---------------------------------------------------------------------------

class PlanFinding(NamedTuple):
    rule: str
    group: int
    msg: str

    def __str__(self) -> str:
        return f"group {self.group}: {self.rule} {self.msg}"


def check_plan(plan, n_buckets: int) -> List[PlanFinding]:
    """Prove (or refute) the planner's commutativity invariant on a
    concrete ``GroupPlan`` before execution.

    strict: within a group any bucket is touched by at most one round.
    lane:   a lane may revisit its own bucket across rounds only when
            every op involved is a read (read-read reuse).
    both:   per-lane per-key program order (``src_t``) is preserved.
    """
    from repro_torch.workloads.plan import _buckets_of
    findings: List[PlanFinding] = []
    keys = np.asarray(plan.keys)
    wr = np.asarray(plan.is_write)
    src = np.asarray(plan.src_t)
    ng, g, c = keys.shape
    bucket = _buckets_of(keys, n_buckets)
    real = keys != 0
    for gi in range(ng):
        if plan.scope == "strict":
            owner: Dict[int, int] = {}
            for r in range(g):
                for l in range(c):
                    if not real[gi, r, l]:
                        continue
                    b = int(bucket[gi, r, l])
                    if owner.setdefault(b, r) != r:
                        findings.append(PlanFinding(
                            "SAN006", gi,
                            f"bucket {b} touched in rounds "
                            f"{owner[b]} and {r} (strict scope)"))
        else:
            for l in range(c):
                seen: Dict[int, bool] = {}
                for r in range(g):
                    if not real[gi, r, l]:
                        continue
                    b = int(bucket[gi, r, l])
                    w = bool(wr[gi, r, l])
                    if b in seen and (seen[b] or w):
                        findings.append(PlanFinding(
                            "SAN006", gi,
                            f"lane {l} revisits bucket {b} at round {r} "
                            f"with a write involved (lane scope)"))
                    seen[b] = seen.get(b, False) or w
    # Program order: a lane's requests for the same key keep their
    # original trace order across the whole plan.
    for l in range(c):
        last_src: Dict[int, int] = {}
        for gi in range(ng):
            for r in range(g):
                if not real[gi, r, l] or src[gi, r, l] < 0:
                    continue
                k = int(keys[gi, r, l])
                t = int(src[gi, r, l])
                if k in last_src and t < last_src[k]:
                    findings.append(PlanFinding(
                        "SAN006", gi,
                        f"lane {l} key {k} scheduled out of program "
                        f"order (row {t} after row {last_src[k]})"))
                last_src[k] = t
    return findings


def assert_plan_ok(plan, n_buckets: int) -> None:
    """Raise ``ValueError`` listing every SAN006 finding (empty = pass)."""
    findings = check_plan(plan, n_buckets)
    if findings:
        raise ValueError(
            "GroupPlan conflict check failed:\n  "
            + "\n  ".join(str(f) for f in findings))
