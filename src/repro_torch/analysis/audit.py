"""dittolint pass 2 for the port: an audit of the graphs the cache entry
points dispatch, the counterpart of ``repro/analysis/jaxpr_audit.py``.

The AST pass sees what the source says; this pass sees what runs.  It
traces the entry points (``access``, ``access_group``,
``run_trace_grouped``, ``dm_execute``, ``ranked_eviction``) with
``make_fx`` over backend x width x tenant configs, on the CPU or on the
card (the hand-written kernels are operators, ``kernels/library.py``, so
each is one node with its inputs and outputs), and walks the FX graphs:

  GX001  an f64 or u64 output of any node;
  GX002  ``_to_copy`` churn: an A -> B -> A round trip of two dtype
         conversions, or more conversions than the entry point's budget
         (CONVERT_BUDGETS: the shipped tree's counts plus ~50 %);
  GX003  a host sync: ``_local_scalar_dense``/``item`` or a ``nonzero``
         (its shape depends on the data): the step replays as a CUDA
         graph, which a sync breaks;
  GX004  a dead output: an entry-point output that is a constant or
         depends on no input (named by its path in the output tree);
  GX005  more captured step graphs than distinct shape signatures over
         a width sweep (``core/cache.py``'s graph key flapping: each
         extra key is a re-capture).  On the CPU, where no graph is
         captured, the keys the steps would be captured under are
         counted.

The JAX package's own audit reports four dead outputs of
``run_trace_grouped`` in each of its four configurations: the stats
``route_drops``, ``replica_drops``, ``l0_hits`` and ``l0_invalidations``,
which no step of a plain trace moves (fresh zeros).  This audit reports
those four and ``replica_writes``, which a plain trace moves by nothing
either: JAX's step adds a literal 0 to it, and JAX's rule takes each
output of a ``scan`` to depend on every input of the scan, so it sees a
computed value; this audit follows each value through the unrolled
steps (:data:`MIRRORED`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

RULES: Dict[str, str] = {
    "GX001": "64-bit float or unsigned dtype (f64/u64) produced in a "
             "traced hot path",
    "GX002": "_to_copy churn (A->B->A round-trip or budget exceeded)",
    "GX003": "host sync (_local_scalar_dense/item/nonzero) in a hot-path "
             "graph",
    "GX004": "dead output: entry-point output is a constant or "
             "independent of every input",
    "GX005": "step-graph capture budget exceeded (more captures than "
             "distinct shape signatures)",
}

# dtype conversions (``_to_copy`` with a new dtype) an entry point may
# make: the shipped tree's largest counts over the configurations (39,
# 39, 115, 28 and 0 on the CPU) plus ~50 %.
CONVERT_BUDGETS: Dict[str, int] = {
    "access": 60,
    "access_group": 60,
    "run_trace_grouped": 175,
    "dm_execute": 42,
    "ranked_eviction": 4,
}

# The dead outputs the JAX package's audit also reports (JX004): leaf
# paths of run_trace_grouped's TraceResult.
JAX_DEAD = (".stats.route_drops", ".stats.replica_drops", ".stats.l0_hits",
            ".stats.l0_invalidations")
# Those and the one JAX's coarser rule does not see (module docstring).
MIRRORED = JAX_DEAD + (".stats.replica_writes",)

_WIDE = (torch.float64, torch.uint64)
_SYNCS = ("_local_scalar_dense", "item", "nonzero")


class Finding(NamedTuple):
    rule: str
    entry: str
    msg: str

    def __str__(self) -> str:
        return f"{self.entry}: {self.rule} {self.msg}"


def _val(node):
    return node.meta.get("val")


def _dtypes(v) -> list:
    if isinstance(v, torch.Tensor):
        return [v.dtype]
    if isinstance(v, (list, tuple)):
        return [d for x in v for d in _dtypes(x)]
    return []


def _src(node) -> str:
    st = node.meta.get("stack_trace") or ""
    lines = [ln.strip() for ln in st.splitlines() if ln.strip()]
    return lines[-2] if len(lines) >= 2 else str(node.target)


def trace(fn, *args):
    """The FX graph of ``fn(*args)`` (real tensors, every op recorded;
    on the card the trace loops run their steps eagerly, not as CUDA
    graphs) and the output tree's leaf paths."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import keystr, tree_flatten_with_path
    out_paths = []

    def flat(*a):
        out = fn(*a)
        out_paths[:] = [keystr(p) for p, _ in
                        tree_flatten_with_path(out)[0]]
        return out

    from repro_torch.core.cache import eager_steps
    with eager_steps():
        gm = make_fx(flat, record_stack_traces=True)(*args)
    return gm, out_paths


def audit_fn(fn, args, entry: str, convert_budget=None) -> List[Finding]:
    """Trace ``fn(*args)`` and audit its graph.  A value read on the host
    while tracing (``.item()``, a tensor in a Python branch) stops the
    trace: that is a GX003 finding at the read."""
    try:
        gm, paths = trace(fn, *args)
    except RuntimeError as e:
        if "_local_scalar_dense" not in str(e):
            raise
        import traceback
        tb = [f for f in traceback.extract_tb(e.__traceback__)
              if "/torch/" not in f.filename]
        at = f"{tb[-1].filename}:{tb[-1].lineno}" if tb else "?"
        return [Finding("GX003", entry, f"a host read stops the trace at "
                        f"{at}")]
    return audit_graph(gm, entry, paths, convert_budget)


def audit_graph(gm, entry: str, paths=None,
                convert_budget=None) -> List[Finding]:
    """GX001-GX004 over one traced graph."""
    g = gm.graph
    findings: List[Finding] = []
    n_convert = 0
    for node in g.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        op = getattr(node.target, "_opname", name)
        for dt in _dtypes(_val(node)):
            if dt in _WIDE:
                findings.append(Finding(
                    "GX001", entry, f"'{name}' produces {dt} at "
                    f"{_src(node)}"))
        if op in _SYNCS:
            findings.append(Finding("GX003", entry,
                                    f"'{name}' at {_src(node)}"))
        if op == "_to_copy" and "dtype" in node.kwargs:
            src = node.args[0]
            src_v, out_v = _val(src), _val(node)
            if src_v is None or out_v is None or src_v.dtype == out_v.dtype:
                continue
            n_convert += 1
            if (src.op == "call_function"
                    and getattr(src.target, "_opname", "") == "_to_copy"):
                inner = _val(src.args[0])
                if inner is not None and inner.dtype == out_v.dtype:
                    findings.append(Finding(
                        "GX002", entry,
                        f"round-trip {inner.dtype} -> {src_v.dtype} -> "
                        f"{out_v.dtype} at {_src(node)}"))
    if convert_budget is not None and n_convert > convert_budget:
        findings.append(Finding(
            "GX002", entry, f"{n_convert} dtype conversions > budget "
            f"{convert_budget}"))
    # GX004: outputs that no placeholder reaches.
    reach = set()
    for node in g.nodes:
        if node.op == "placeholder" or any(
                a in reach for a in node.all_input_nodes):
            reach.add(node)
    out = next(n for n in g.nodes if n.op == "output")
    leaves = out.args[0]
    leaves = list(leaves) if isinstance(leaves, (list, tuple)) else [leaves]
    for i, v in enumerate(leaves):
        where = paths[i] if paths and i < len(paths) else f"output[{i}]"
        if not isinstance(v, torch.fx.Node):
            findings.append(Finding("GX004", entry,
                                    f"{where} is the constant {v!r}"))
        elif v not in reach:
            findings.append(Finding(
                "GX004", entry, f"{where} ({v.target}) does not depend on "
                "any input"))
    return findings


def count_captures(step_fn, calls) -> tuple:
    """(step-graph keys made, distinct shape signatures) over ``calls``
    (each run twice).  On the card the captured graphs are counted
    (``core/cache.py``'s cache); on the CPU the keys ``_scan`` would
    capture under are recorded."""
    from repro_torch.core import cache as C
    seen = set()
    orig = C._scan

    def scan(step, carry, xs, key, **kw):
        if xs[0].shape[0]:
            seen.add((key, xs[0].device, C._sig(C._leaves(carry)),
                      C._sig(x[0] for x in xs)))
        return orig(step, carry, xs, key, **kw)

    before = len(C._GRAPHS)
    C._scan = scan
    try:
        for args in list(calls) * 2:
            step_fn(*args)
    finally:
        C._scan = orig
    sigs = {tuple((tuple(a.shape), a.dtype) for a in args
                  if isinstance(a, torch.Tensor)) for args in calls}
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                  for args in calls for a in args)
    return (len(C._GRAPHS) - before if on_card else len(seen)), len(sigs)


# ----------------------------------------------------------------------
# The entry-point harness: tiny configs, real code paths.
# ----------------------------------------------------------------------

def _small_cfg(backend: str, n_tenants: int):
    from repro_torch.core.types import CacheConfig
    return CacheConfig(n_buckets=64, assoc=4, capacity=64, hist_len=64,
                       backend=backend, n_tenants=n_tenants)


def audit_entry_points(device="cpu", widths=(1, 8),
                       backends=("reference", "fused"), tenants=(1, 2),
                       n_clients: int = 4, include_dm: bool = True,
                       retrace_widths=(1, 8, 32)) -> List[Finding]:
    """Trace every entry point across backend x width x tenant configs and
    audit the graphs, on ``device`` ("cpu", or "cuda": the card's form,
    the kernels launched); then the GX005 capture budget."""
    from repro_torch.core.cache import (_run_trace_grouped_impl, access,
                                        access_group)
    from repro_torch.core.types import init_cache, init_clients, init_stats
    dev = torch.device(device)
    findings: List[Finding] = []
    for backend in backends:
        for tn in tenants:
            cfg = _small_cfg(backend, tn)
            st, cl = init_cache(cfg, dev), init_clients(cfg, n_clients,
                                                        device=dev)
            sa = init_stats(dev)
            ones = torch.ones((n_clients,), dtype=torch.int64, device=dev)
            ten = torch.zeros((n_clients,), dtype=torch.int64, device=dev)
            findings += audit_fn(
                lambda s, c, a, k: access(cfg, s, c, a, k, tenant=ten),
                (st, cl, sa, ones), "access", CONVERT_BUDGETS["access"])
            for g in widths:
                keys = torch.ones((g, n_clients), dtype=torch.int64,
                                  device=dev)
                findings += audit_fn(
                    lambda s, c, a, k: access_group(cfg, s, c, a, k),
                    (st, cl, sa, keys), "access_group",
                    CONVERT_BUDGETS["access_group"])
            keys = torch.ones((3, 2, n_clients), dtype=torch.int64,
                              device=dev)
            findings += audit_fn(
                lambda s, c, k: _run_trace_grouped_impl(cfg, s, c, k),
                (st, cl, keys), "run_trace_grouped",
                CONVERT_BUDGETS["run_trace_grouped"])
    findings += _audit_ranked_eviction(dev)
    if include_dm:
        findings += _audit_dm(dev)
    findings += audit_captures(dev, retrace_widths, backends, n_clients)
    return findings


def _audit_ranked_eviction(dev) -> List[Finding]:
    """The fused eviction op's checked wrapper (the draw form, as the
    step calls it)."""
    from repro_torch.kernels import ops
    w, k, b, c = 20, 5, 8, 256
    col = torch.zeros((c,), dtype=torch.int64, device=dev)
    rng = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    cdf = torch.full((4, 2), 0.5, device=dev)
    return audit_fn(
        lambda s, i, l, f, r, p, m, q, t: ops.ranked_eviction_draw_op(
            s, i, l, f, r, p, m, q, t, window=w, k=k,
            experts=("lru", "lfu")),
        (col, col, col, col, rng, cdf,
         torch.ones((b,), dtype=torch.bool, device=dev),
         torch.ones((b,), dtype=torch.int64, device=dev),
         torch.ones((b,), dtype=torch.int64, device=dev)),
        "ranked_eviction", CONVERT_BUDGETS["ranked_eviction"])


def _audit_dm(dev, n_shards: int = 2, lanes: int = 4) -> List[Finding]:
    """``dm_execute`` (the routing, the exchange and the shard steps)
    on a small pool of ``n_shards`` shards."""
    from repro_torch.core.types import CacheConfig
    from repro_torch.dm.sharded_cache import _dm_make_impl, dm_execute
    cfg = CacheConfig(n_buckets=64 * n_shards, assoc=4,
                      capacity=64 * n_shards, hist_len=64 * n_shards)
    _, dm, local = _dm_make_impl(cfg, n_shards, lanes, device=dev)
    keys = torch.ones((1, n_shards * lanes), dtype=torch.int64, device=dev)
    return audit_fn(lambda d, k: dm_execute(local, d, k), (dm, keys),
                    "dm_execute", CONVERT_BUDGETS["dm_execute"])


def audit_captures(dev, widths=(1, 8, 32), backends=("reference", "fused"),
                   n_clients: int = 4) -> List[Finding]:
    """GX005: a width sweep over one config must make one step graph per
    shape signature."""
    from repro_torch.core.cache import _run_trace_grouped_impl
    from repro_torch.core.types import init_cache, init_clients
    findings: List[Finding] = []
    for backend in backends:
        cfg = _small_cfg(backend, 1)
        st, cl = init_cache(cfg, dev), init_clients(cfg, n_clients,
                                                    device=dev)
        calls = [(st, cl, torch.ones((2, g, n_clients), dtype=torch.int64,
                                     device=dev)) for g in widths]
        made, sigs = count_captures(
            lambda s, c, k: _run_trace_grouped_impl(cfg, s, c, k), calls)
        if made > sigs:
            findings.append(Finding(
                "GX005", "run_trace_grouped",
                f"{backend}: {made} step graphs for {sigs} width signatures "
                f"{tuple(widths)}"))
    return findings


def mirrored(findings) -> bool:
    """True if ``findings`` are exactly the mirrored GX004 leaves of
    ``run_trace_grouped``, once per configuration."""
    return all(f.rule == "GX004" and f.entry == "run_trace_grouped"
               and f.msg.split(" ")[0] in MIRRORED for f in findings)

