"""The device trace of a traced run: ``torch.profiler`` over a few calls
of the window, reduced to device time, busy and idle, kernels by name,
and the longest idle gaps with what the host was doing in each."""

from __future__ import annotations

import contextlib

CALL_SPAN = "bench.call"

# Kernel families of the program's fused step, by the CUDA function name.
FAMILIES = dict(access_probe=("access_probe_kernel",),
                hit_metadata_update=("hmu_",),
                ranked_eviction=("ranked_eviction_kernel",),
                drop_scatter=("drop_scatter_kernel",))


class Tracer:
    """Profiles the calls made inside :meth:`calls`; each call is marked
    with :meth:`span`."""

    def __init__(self):
        self.prof = None

    @contextlib.contextmanager
    def calls(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            yield

    @staticmethod
    def span():
        import torch
        return torch.profiler.record_function(CALL_SPAN)

    def reduce(self) -> dict | None:
        """:func:`summarize` of the profiled calls; None without a trace."""
        if self.prof is None:
            return None
        dev, host, spans = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                # A span's shadow on the device's timeline is no work.
                if not e.is_user_annotation():
                    dev.append((t0, t1, e.name()))
            elif e.name() == CALL_SPAN:
                spans.append((t0, t1))
            else:
                host.append((t0, t1, e.name()))
        return summarize(dev, host, spans)


def summarize(dev, host, spans) -> dict | None:
    """From device events and host events (start ns, end ns, name) and
    the calls' spans (start ns, end ns): busy_s and window_s (the spans'
    extent), the kernel count, each family's device time, the device
    operations that took most time, and the longest idle gaps labelled
    by the host event that overlaps each most.  None without spans."""
    if not spans:
        return None
    lo = min(s for s, _ in spans)
    hi = max(e for _, e in spans)
    by_name, kernels = {}, 0
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        if not n.startswith("Memcpy") and not n.startswith("Memset"):
            kernels += 1
    family = {f: sum(t for n, t in by_name.items()
                     if any(p in n for p in pre))
              for f, pre in FAMILIES.items()}
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, _ in dev
                   if e > lo and s < hi])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = [(s, e) for (_, s), (e, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    else:
        gaps = [(lo, hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:10]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        busy_s=busy_s, window_s=(hi - lo) * 1e-9, kernels=kernels,
        family_s=family, device_ops=[[n[:160], t] for n, t in top],
        idle_gaps=[[_host_label(host, s, e), (e - s) * 1e-9]
                   for s, e in gaps])


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _host_label(host, s, e):
    """The host event that overlaps the gap most (the innermost of
    equals), and the share of the gap that traced host events cover (the
    rest is host work no operator records, such as planning in NumPy)."""
    best, label = (0, 0), "no traced operator"
    for hs, he, name in host:
        ov = min(he, e) - max(hs, s)
        if ov > 0 and (ov, hs - he) > best:
            best, label = (ov, hs - he), name
    covered = sum(e2 - s2 for s2, e2 in _merge(
        [(max(hs, s), min(he, e)) for hs, he, _ in host]))
    return f"host: {label} ({covered / (e - s):.0%} of the gap traced)"[:160]
