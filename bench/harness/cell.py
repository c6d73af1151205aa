"""One run of one cell: set-up, the measured window, the traced calls,
the check against the plain reference, and the result.

The traffic is a closed loop: the cell's client lanes hand the next
call's rows to the program and wait for it to return before the next.
Set-up makes the program's state on the device from the seed, runs the
load phase (its first call builds the kernels and captures the step's
CUDA graph) and ``warm_calls`` calls of the run's traffic, and the window
then runs calls until ``seconds`` have passed.  The card runs the step
up to a fifth slower for the first 5 to 35 s of a process's device work
(device time, not the host's; at the same clocks), so the warm calls
last about 20 s.  A request's latency is its call's,
from the call's submission to its return (which ends in a device sync);
a request that fails counts as infinite.

The check runs once the window has closed and the program is freed.  The
reference starts from its own initial state, made from the configuration
and the seed, and runs the whole load phase (which evicts once the pool
is full); every call's outputs and the state after the last are compared
with the program's.  In the window, ``check.cases`` runs of
``check.calls`` consecutive calls, at positions drawn from the seed, are
followed from the program's state before each run: the state is copied
to the host before and after it, and the reference runs the same calls
from the first copy.  The state at the close is held to the invariants
that need no reference.
"""

from __future__ import annotations

import importlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench.harness import check, spec
from bench.harness.bytes import PARTS, call_bytes
from bench.harness.trace import Tracer
from bench.harness.traffic import Stream

# Rows a call of the load phase.
LOAD_ROWS = 2048


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Snapshots:
    """Host copies of the program's state, into buffers made at set-up
    (pinned, on the card), so a copy in the window costs a transfer."""

    def __init__(self, leaves: dict, n: int, pin: bool):
        self.free = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                      for k, v in leaves.items()} for _ in range(n)]

    def take(self, leaves: dict) -> dict:
        buf = self.free.pop()
        for k, v in leaves.items():
            buf[k].copy_(v, non_blocking=True)
        if any(v.is_cuda for v in leaves.values()):
            torch.cuda.synchronize()
        return buf


def p95(calls: list) -> float:
    """The 95th percentile (nearest rank) over every request of the
    window: a call's requests take its latency, a failed one infinity."""
    lat, cnt = [], []
    for c in calls:
        lat.append(c["t1"] - c["t0"])
        cnt.append(c["requests"] - c.get("failed", 0))
    lat.append(float("inf"))
    cnt.append(sum(c.get("failed", 0) for c in calls))
    order = np.argsort(lat, kind="stable")
    cum = np.cumsum(np.asarray(cnt, np.int64)[order])
    rank = int(np.ceil(0.95 * cum[-1]))
    return float(np.asarray(lat)[order][np.searchsorted(cum, rank)])


def setup(cell: dict, seed: int, dev, n_snapshots: int):
    """The program and its traffic from the seed, the load phase and the
    warm calls.  Returns (stream, program, snapshots, the load phase: its
    calls with their outputs and the state after the last)."""
    config, mix = cell["config"], cell["mix"]
    kind = importlib.import_module(f"bench.kinds.{config['kind']}")
    t0 = time.perf_counter()
    stream = Stream.from_mix(mix, kind.width(config), seed)
    log(f"trace pool: {stream.keys.shape[0]} rows x {stream.keys.shape[1]} "
        f"lanes; a window that serves more replays it cyclically from row "
        f"{stream.start}, which the seed chose ({time.perf_counter() - t0:.2f}"
        f" s)")
    t0 = time.perf_counter()
    prog = kind.Program(config, mix, seed, dev)
    snaps = Snapshots(prog.leaves(), n_snapshots, dev.type == "cuda")
    log(f"program and snapshot buffers: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    load = dict(calls=[])
    for keys, wr in stream.load_calls(mix["load_keys"], LOAD_ROWS,
                                      kind.align(config)):
        rec = prog.call(keys, wr, keep=True)
        load["calls"].append((keys, wr, rec["out"]))
    load["after"] = snaps.take(prog.leaves())
    log(f"load phase: {sum(int((k != 0).sum()) for k, _, _ in load['calls'])}"
        f" SETs of distinct keys in {len(load['calls'])} calls; n_cached "
        f"{int(prog.leaves()['state.n_cached'].sum())} "
        f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    for _ in range(int(mix["warm_calls"])):
        prog.call(*stream.next())
    log(f"{mix['warm_calls']} warm calls: {time.perf_counter() - t0:.2f} s")
    return stream, prog, snaps, load


def reference_check(kind, config: dict, seed: int, load: dict, cases: list,
                    dev) -> dict:
    """The tally of the program's load phase against the reference's from
    its own initial state, and of each case (a run of consecutive calls)
    against the reference's from the program's state before it."""
    tally = check.new_tally()
    runs = [(kind.reference_init(config, seed, dev), load)] \
        + [(c["before"], c) for c in cases]
    for before, run in runs:
        want_after, want_outs = kind.reference_calls(
            config, before, [(k, w) for k, w, _ in run["calls"]], dev)
        check.merge(tally, check.compare_state(run["after"], want_after))
        for (_, _, got), want in zip(run["calls"], want_outs):
            check.merge(tally, kind.compare_outputs(got, want))
        del want_after
    return tally


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             max_calls: int | None = None) -> dict:
    """Run a cell (:func:`spec.load_cell`) once; returns the result object
    of the run's last line.  ``max_calls``: the window ends after that
    many calls, not after ``seconds`` (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, mix = cell["config"], cell["mix"]
    kind = importlib.import_module(f"bench.kinds.{config['kind']}")
    dev = torch.device(device)
    n_cases = int(config["check"]["cases"])
    case_calls = int(config["check"]["calls"])

    stream, prog, snaps, load = setup(cell, seed, dev, 1 + 2 * n_cases)
    rng = np.random.default_rng(seed + 41)
    check_at = sorted(rng.uniform(0.05, 0.95, n_cases) * seconds)
    trace_at = 0.5 * seconds if trace else None
    tracer = Tracer()
    traced, traced_s = [], 0.0
    counters0 = prog.counters()

    calls, cases, case = [], [], None
    t_w = time.perf_counter()
    setup_s = t_w - t_start
    while True:
        now = time.perf_counter() - t_w
        if trace_at is not None and now >= trace_at and case is None:
            trace_at = None
            t_trace = time.perf_counter()
            with tracer.calls():
                for _ in range(int(mix["trace_calls"])):
                    before = prog.counters()
                    keys, wr = stream.next()
                    with tracer.span():
                        t0 = time.perf_counter()
                        rec = prog.call(keys, wr, keep=True)
                    rec["t0"] = t0
                    calls.append(rec)
                    after = prog.counters()
                    rec["delta"] = {k: after[k] - before[k] for k in after}
                    traced.append(rec)
            # The profiler's start, its stop and the trace's processing.
            traced_s = time.perf_counter() - t_trace
            continue
        if case is None and check_at and now >= check_at[0]:
            check_at.pop(0)
            case = dict(before=snaps.take(prog.leaves()), calls=[])
        keys, wr = stream.next()
        t0 = time.perf_counter()
        rec = prog.call(keys, wr, keep=case is not None)
        rec["t0"] = t0
        calls.append(rec)
        if case is not None:
            case["calls"].append((keys, wr, rec.pop("out")))
            if len(case["calls"]) == case_calls:
                case["after"] = snaps.take(prog.leaves())
                cases.append(case)
                case = None
        if case is None and (len(calls) >= max_calls if max_calls
                             else rec["t1"] - t_w >= seconds):
            break
    window_s = calls[-1]["t1"] - t_w
    tenths = [sum(c["requests"] for c in calls
                  if i / 10 <= (c["t1"] - t_w) / window_s < (i + 1) / 10)
              / (window_s / 10) for i in range(10)]
    log("requests/s by tenth of the window: "
        + " ".join(f"{r:.0f}" for r in tenths))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counters1 = prog.counters()
    delta = {k: counters1[k] - counters0[k] for k in counters1}
    attempted = sum(c["requests"] for c in calls)
    failed = sum(c.get("failed", 0) for c in calls)
    if stream.replayed:
        log("the window replayed the trace pool")

    # The state at the close, against what no reference is needed for.
    tally = check.new_tally()
    tally["invariants"] += check.invariants(
        prog.leaves(), config["cache"]["n_buckets"],
        config["cache"]["assoc"], kind.n_shards(config))
    tally["invariants"] += int(delta["gets"] + delta["sets"]
                               + delta["route_drops"] != attempted)
    tally["invariants"] += int(delta["route_drops"] != failed)
    prog.release()
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reduced = tracer.reduce()
    t1 = time.perf_counter()
    check.merge(tally, reference_check(kind, config, seed, load, cases, dev))
    log(f"{len(calls)} calls in the window; the load phase's "
        f"{len(load['calls'])} calls and {len(cases)} run(s) of "
        f"{case_calls} checked; trace {t1 - t0:.2f} s, reference "
        f"{time.perf_counter() - t1:.2f} s")
    log("check detail: " + ", ".join(f"{k} {tally[k]}" for k in check.EXACT))
    numbers = check.compared(tally)
    limits = config["check"]["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}

    if dev.type == "cuda":
        device_out = dict(platform="gpu",
                          kind=torch.cuda.get_device_name(dev),
                          count=cell["chips"], memory_peak_bytes=int(peak))
    else:
        device_out = dict(platform="cpu", kind="cpu", count=1,
                          memory_peak_bytes=0)
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed))
    if not trace:
        served = attempted - failed
        values = dict(requests_per_s=served / window_s,
                      latency_p95_ms=1e3 * p95(calls),
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell["end_to_end"]}
    else:
        # The per-layer metrics read the window less the traced calls,
        # which the profiler slows, and read those calls' trace.
        ctx = SimpleNamespace(
            kind=config["kind"], config=config,
            calls=[c for c in calls if not any(c is t for t in traced)],
            window_s=window_s - traced_s, attempted=attempted,
            failed=failed, counters=delta,
            trace=_trace_ctx(kind, config, traced, reduced))
        out["metrics"] = {}
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if reduced is not None:
            device_out.update(busy_s=reduced["busy_s"],
                              window_s=reduced["window_s"])
            out["breakdown"] = dict(device_ops=reduced["device_ops"],
                                    idle_gaps=reduced["idle_gaps"])
    out["device"] = device_out
    out["checks"] = checks
    return out


def _trace_ctx(kind, config, traced: list, reduced: dict | None):
    """The traced calls' steps and the bytes their requests need, beside
    the trace's own numbers."""
    if reduced is None:
        return None
    cache = config["cache"]
    need = dict.fromkeys(PARTS, 0)
    steps = 0
    for rec in traced:
        groups, is_write, hits = kind.steps_of(rec)
        steps += len(groups)
        part = call_bytes(groups, is_write, hits, rec["delta"],
                          n_buckets=cache["n_buckets"], assoc=cache["assoc"],
                          n_samples=cache.get("n_samples", 5),
                          n_experts=len(cache["experts"]),
                          value_words=cache.get("value_words", 2))
        for k in PARTS:
            need[k] += part[k]
    return dict(reduced, steps=steps, bytes=need)
