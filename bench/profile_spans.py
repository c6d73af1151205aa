"""The program's spans (``src/repro_torch/core/spans.py``) read on the
card at a cell's full size: a call split into the carry's copy into the
step's graph and out, the graph's replays and the rest; the device's
idle time by the innermost open span; and what the spans cost.

    python3 bench/profile_spans.py --workload pool2m-ycsb-a \\
        --seed 3141592653 --out chiprun_out/spans_a.json

The cell is set up as a run sets it up (``harness/cell.py::setup``: the
load phase and the warm calls).  Then, in turn: untraced calls, timed;
profiled calls with the program's spans; profiled calls with the spans
switched off (their cost under the profiler); each profiled call inside
a ``bench.call`` span between two reads of the program's counters, as a
traced run makes it.  :func:`split` reduces each profile.  The harness
reads no span yet, so this is not a cell's run: ``PERF.md`` (Open
questions) names the harness edits that would make these per-layer
metrics.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

BETWEEN = "between calls"
UNTRACED_CALLS = 400                # a turn of untraced calls


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(busy, ends, a, b) -> int:
    """The length of [a, b) that the merged, sorted ``busy`` covers
    (``ends``: their ends)."""
    n = 0
    for s, e in busy[bisect.bisect_right(ends, a):]:
        if s >= b:
            break
        n += min(e, b) - max(s, a)
    return n


def _pieces(host, lo, hi) -> list:
    """[lo, hi) cut into (start, end, name) pieces, each named by the
    innermost host span open over it (None where none is): the spans of
    one thread nest."""
    out, stack, t = [], [], lo

    def emit(upto):
        nonlocal t
        upto = min(max(upto, lo), hi)
        if upto > t:
            out.append((t, upto, stack[-1][2] if stack else None))
            t = upto

    for s, e, n in sorted(host, key=lambda h: (h[0], -h[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((s, e, n))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(hi)
    return out


def split(dev, host, shadows, calls) -> dict | None:
    """From device events (start ns, end ns, name), the program's host
    spans and their device shadows (start ns, end ns, span name) and the
    calls' ``bench.call`` spans (start ns, end ns): over the calls'
    extent, ``busy_s`` and ``window_s``; for each span name its count,
    host seconds, the device's busy seconds inside its shadows (the union
    of device intervals, clipped to them) and the kernels that start
    inside them; ``execute_idle_s``, the device's idle time while a
    ``ditto.execute`` span is open; ``idle_by_span``, the extent's idle
    time by the innermost open span.  None without calls."""
    if not calls:
        return None
    lo, hi = min(s for s, _ in calls), max(e for _, e in calls)
    busy = _merge((max(s, lo), min(e, hi)) for s, e, _ in dev
                  if e > lo and s < hi)
    ends = [e for _, e in busy]
    starts = sorted(s for s, _, n in dev
                    if not n.startswith(("Memcpy", "Memset")))
    spans = {}
    for name in sorted({n for _, _, n in host}):
        sh = _merge((s, e) for s, e, n in shadows if n == name)
        spans[name] = dict(
            count=sum(1 for *_, n in host if n == name),
            host_s=sum(e - s for s, e, n in host if n == name) * 1e-9,
            busy_s=sum(_covered(busy, ends, a, b) for a, b in sh) * 1e-9,
            kernels=sum(bisect.bisect_left(starts, b)
                        - bisect.bisect_left(starts, a) for a, b in sh))
    idle = {}
    for a, b, n in _pieces(host, lo, hi):
        key = n or BETWEEN
        idle[key] = idle.get(key, 0) + (b - a) - _covered(busy, ends, a, b)
    ex = _merge((max(s, lo), min(e, hi)) for s, e, n in host
                if n == "ditto.execute")
    return dict(
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        window_s=(hi - lo) * 1e-9, calls=len(calls),
        execute_idle_s=sum(b - a - _covered(busy, ends, a, b)
                           for a, b in ex) * 1e-9,
        spans=spans,
        idle_by_span=[[k, v * 1e-9] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


def metrics(r: dict) -> dict:
    """The per-layer numbers a profile gives (None where it has no
    span to read)."""
    sp = r["spans"]
    step = sp.get("ditto.scan.step")
    copies = [sp[k]["busy_s"] for k in ("ditto.scan.copy_in",
                                        "ditto.scan.copy_out") if k in sp]
    return dict(
        carry_copy_ms_per_call=1e3 * sum(copies) / r["calls"]
        if copies else None,
        graph_replay_us_per_step=1e6 * step["busy_s"] / step["count"]
        if step else None,
        graph_kernels_per_step=step["kernels"] / step["count"]
        if step else None,
        execute_idle_share=100.0 * r["execute_idle_s"] / r["window_s"]
        if "ditto.execute" in sp else None,
        device_idle_share=100.0 * (1.0 - r["busy_s"] / r["window_s"]))


def _events(prof):
    dev, host, shadows, calls = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        t0, n = e.start_ns(), e.name()
        t1 = t0 + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                dev.append((t0, t1, n))
            elif n.startswith("ditto."):
                shadows.append((t0, t1, n))
        elif n == "bench.call":
            calls.append((t0, t1))
        elif n.startswith("ditto."):
            host.append((t0, t1, n))
    return dev, host, shadows, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.harness import spec
    from bench.harness.cell import log, setup
    from repro_torch.core import spans

    if not torch.cuda.is_available():
        log("profile_spans.py measures the card; this machine has none")
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    stream, prog, _, _ = setup(cell, args.seed, dev, 1)
    out = dict(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(dev), turns=[])
    counters0 = spans.counters()
    real = spans.span

    def turn(mode: str) -> dict:
        if mode == "untraced":
            ts = []
            for _ in range(UNTRACED_CALLS):
                keys, wr = stream.next()
                t0 = time.perf_counter()
                prog.call(keys, wr)
                ts.append(time.perf_counter() - t0)
            return dict(mode=mode, call_ms=1e3 * statistics.median(ts))
        if mode == "spans_off":
            spans.span = lambda name: contextlib.nullcontext()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(int(cell["mix"]["trace_calls"])):
                    prog.counters()
                    keys, wr = stream.next()
                    with torch.profiler.record_function("bench.call"):
                        prog.call(keys, wr)
                    prog.counters()
        finally:
            spans.span = real
        dev_ev, host, shadows, calls = _events(prof)
        r = split(dev_ev, host, shadows, calls)
        return dict(r, mode=mode, metrics=metrics(r), call_ms=1e3 *
                    statistics.median((e - s) * 1e-9 for s, e in calls))

    for mode in ("untraced", "spans_on", "spans_off", "untraced",
                 "spans_off", "spans_on", "untraced"):
        out["turns"].append(turn(mode))
        t = out["turns"][-1]
        log(f"{mode}: median call {t['call_ms']:.4f} ms"
            + (f"; {json.dumps(t['metrics'])}" if "metrics" in t else ""))
    out["graph_captures_in_window"] = (spans.counters()["graph_captures"]
                                       - counters0["graph_captures"])
    for on in (False, True):
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if on else contextlib.nullcontext()):
            n = 20_000 if on else 200_000
            t0 = time.perf_counter()
            for _ in range(n):
                with spans.span("ditto.probe"):
                    pass
            out[f"span_us_profiler_{'on' if on else 'off'}"] = \
                1e6 * (time.perf_counter() - t0) / n
    log(f"graph captures in the turns: {out['graph_captures_in_window']}; "
        f"a span's enter and exit: {out['span_us_profiler_off']:.3f} us "
        f"with no profiler, {out['span_us_profiler_on']:.3f} us under one")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
