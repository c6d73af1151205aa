"""dittolint for the port: ``python -m repro_torch.analysis``.

Modes (combinable; any finding in any selected pass fails the run):

  (default)          AST lint (DL0xx) over ``src/repro_torch`` or the
                     given paths.
  --audit            Graph audit (GX0xx) of the entry points across
                     backend x width x tenant configs (``--device cuda``:
                     their form on the card, kernels launched).  The dead
                     outputs that are dead in the JAX package's step too
                     (``audit.MIRRORED``) are printed, not counted.
  --plan-check       Build strict and lane ``GroupPlan``s and prove SAN006
                     conflict freedom; a seeded overlap must be caught.
  --sanitize-smoke   Run a seeded trace with ``sanitize=True`` (clean must
                     pass) and hold ``sanitize=False`` bit-identical.
  --demo RULE        Run RULE's seeded-violation fixture; exits 1 when the
                     rule fires (the expected outcome), 3 when it does not.
  --selftest         Run every rule's fixture; exits 0 only if every rule
                     fires on its fixture.
  --list-rules       Print the full rule catalog.

Exit codes: 0 clean / selftest pass, 1 findings (or a fixture firing
under --demo), 2 usage error, 3 broken fixture under --demo.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1]

# Seeded violations: one per AST rule, each placed inside its rule's
# scope by its path.
_AST_FIXTURES = {
    "DL001": ("src/repro_torch/core/cache.py",
              "import torch\n"
              "def f(x):\n"
              "    if torch.any(x > 0):\n"
              "        return x.sum().item()\n"
              "    return 0\n"),
    "DL002": ("src/repro_torch/core/cache.py",
              "from repro_torch.core import prng\n"
              "def f(key):\n"
              "    a = prng.uniform(key, 4)\n"
              "    b = prng.uniform(key, 4)\n"
              "    return a + b\n"),
    "DL003": ("src/repro_torch/kernels/_fixture.py",
              "import torch\n"
              "def rank(x):\n"
              "    return torch.argsort(x)\n"),
    "DL004": ("src/repro_torch/core/cache.py",
              "import torch\n"
              "def f(x):\n"
              "    return x.to(torch.float64)\n"),
    "DL005": ("src/repro_torch/core/cache.py",
              "from repro_torch.kernels import ref\n"
              "def f(k, s, keys):\n"
              "    return ref.bucket_lookup_ref(k, s, keys, assoc=8)\n"),
    "DL006": ("src/repro_torch/core/cache.py",
              "def f(x, acc=[]):\n"
              "    acc.append(x)\n"
              "    return acc\n"),
    "DL007": ("src/repro_torch/workloads/_fixture.py",
              "from repro_torch.core.cache import run_trace\n"
              "def f(cfg, st, cl, keys, wr):\n"
              "    return run_trace(cfg, st, cl, keys, wr)\n"),
    "DL008": ("src/repro_torch/workloads/_fixture.py",
              "from repro_torch.dm import dm_set_capacity\n"
              "from repro_torch.elastic import set_capacity\n"
              "def f(dm):\n"
              "    dm = dm_set_capacity(dm, 1024, 8)\n"
              "    return set_capacity(dm, 1024, 8)\n"),
    "DL009": ("src/repro_torch/models/_fixture.py",
              "import jax.numpy as jnp\n"
              "from repro.core import cache\n"),
}


def _demo_ast(rule: str):
    from repro_torch.analysis import astlint
    path, src = _AST_FIXTURES[rule]
    return [str(f) for f in astlint.lint_source(src, path) if f.rule == rule]


def _demo_graph(rule: str, device: str = "cpu"):
    import torch

    from repro_torch.analysis import audit
    dev = torch.device(device)
    x = torch.ones((4,), device=dev)
    if rule == "GX001":
        gm, paths = audit.trace(lambda x: x.double() * 2, x)
    elif rule == "GX002":
        gm, paths = audit.trace(lambda x: x.float().long(), x.long())
    elif rule == "GX003":
        return [str(f) for f in audit.audit_fn(
            lambda x: x * x.sum().item(), (x,), "fixture")]
    elif rule == "GX004":
        gm, paths = audit.trace(
            lambda x: (x * 2, torch.zeros((2,), device=dev)), x)
    elif rule == "GX005":
        from repro_torch.core import cache as C

        def flapping(k):
            # A step key that differs per call: a re-capture each time.
            return C._scan(lambda c, x: (c, x[0]), ((k,),), (k[None],),
                           object())
        made, sigs = audit.count_captures(flapping, [(x,)])
        found = ([audit.Finding("GX005", "fixture", f"{made} step graphs "
                                f"for {sigs} shape signature")]
                 if made > sigs else [])
        return [str(f) for f in found]
    else:
        raise KeyError(rule)
    return [str(f) for f in audit.audit_graph(gm, "fixture", paths)
            if f.rule == rule]


def _san_fixture_state():
    import torch

    from repro_torch.core.cache import access_group
    from repro_torch.core.types import (CacheConfig, init_cache, init_clients,
                                        init_stats)
    cfg = CacheConfig(n_buckets=64, assoc=4, capacity=64, hist_len=64,
                      n_tenants=2, tenant_budget_blocks=(32, 32),
                      sanitize=True)
    st = init_cache(cfg, "cpu")
    cl = init_clients(cfg, 4, device="cpu")
    sa = init_stats("cpu")
    keys = (torch.arange(1, 33).reshape(8, 4) % 7) + 1
    import dataclasses
    plain = dataclasses.replace(cfg, sanitize=False)
    st, cl, sa, _ = access_group(
        plain, st, cl, sa, keys, is_write=torch.ones((8, 4), dtype=bool),
        tenant=torch.zeros((8, 4), dtype=torch.int64))
    return cfg, st, cl


def _demo_sanitize(rule: str):
    from repro_torch.analysis import sanitize

    if rule == "SAN006":
        import numpy as np

        from repro_torch.workloads.plan import GroupPlan
        k = np.full((1, 2, 1), 7, np.uint32)     # same key both rounds
        plan = GroupPlan(k, np.zeros_like(k, bool), np.ones_like(k),
                         np.zeros_like(k, np.int32), batch=2, scope="strict")
        return [str(f) for f in sanitize.check_plan(plan, 64)
                if f.rule == rule]

    cfg, st, cl = _san_fixture_state()
    if rule == "SAN001":
        bad = st._replace(bytes_cached=st.bytes_cached + 5)
        probe = lambda: sanitize.check_state(cfg, bad, rules=[rule])
    elif rule == "SAN002":
        over = st._replace(tenant_bytes=st.tenant_budget + 1,
                           bytes_cached=(st.tenant_budget + 1).sum())
        probe = lambda: sanitize.check_step(cfg, st, over, rules=[rule])
    elif rule == "SAN003":
        key2, sz2 = st.key.clone(), st.size.clone()
        key2[:2], sz2[:2] = 7, 1
        bad = st._replace(key=key2, size=sz2)
        probe = lambda: sanitize.check_state(cfg, bad, rules=[rule])
    elif rule == "SAN004":
        bad = st._replace(weights=st.weights * 0 + 2.0)
        probe = lambda: sanitize.check_state(cfg, bad, rules=[rule])
    elif rule == "SAN005":
        sz2, ts2 = st.size.clone(), st.last_ts.clone()
        sz2[0], ts2[0] = 1, st.clock + 5
        bad = st._replace(size=sz2, last_ts=ts2)
        probe = lambda: sanitize.check_state(cfg, bad, rules=[rule])
    else:
        raise KeyError(rule)
    try:
        probe()
    except sanitize.SanitizerError as e:
        msg = str(e)
        return [msg.splitlines()[0]] if rule in msg else []
    return []


def run_demo(rule: str, device: str = "cpu"):
    if rule.startswith("DL"):
        return _demo_ast(rule)
    if rule.startswith("GX"):
        return _demo_graph(rule, device)
    if rule.startswith("SAN"):
        return _demo_sanitize(rule)
    raise KeyError(rule)


def run_astlint(paths):
    from repro_torch.analysis import astlint
    return [str(f) for f in astlint.lint_paths(paths)]


def run_audit(device: str = "cpu", log=print):
    """The audit's findings, less the mirrored dead outputs (printed)."""
    from repro_torch.analysis import audit
    out = []
    for f in audit.audit_entry_points(device=device):
        if audit.mirrored([f]):
            log(f"{f} (mirrored: dead in the JAX package's step too)")
        else:
            out.append(str(f))
    return out


def run_plan_check():
    import numpy as np

    from repro_torch.analysis import sanitize
    from repro_torch.workloads.plan import GroupPlan, plan_groups

    rng = np.random.RandomState(0)
    keys = (rng.zipf(1.3, size=(64, 8)) % 97 + 1).astype(np.uint32)
    wr = rng.rand(64, 8) < 0.3
    out = []
    for scope in ("strict", "lane"):
        plan = plan_groups(keys, 64, 4, scope=scope, is_write=wr)
        out += [str(f) for f in sanitize.check_plan(plan, 64)]
    k = np.full((1, 2, 1), 7, np.uint32)
    seeded = GroupPlan(k, np.zeros_like(k, bool), np.ones_like(k),
                       np.zeros_like(k, np.int32), batch=2, scope="strict")
    if not sanitize.check_plan(seeded, 64):
        out.append("plan-check: SAN006 negative control did NOT fire "
                   "(checker is vacuous)")
    return out


def run_sanitize_smoke():
    import dataclasses

    import torch

    from repro_torch.analysis import sanitize
    from repro_torch.core.cache import _run_trace_impl
    from repro_torch.core.types import CacheConfig, init_cache, init_clients

    out = []
    for backend in ("reference", "fused"):
        cfg = CacheConfig(n_buckets=64, assoc=4, capacity=64, hist_len=64,
                          backend=backend)
        scfg = dataclasses.replace(cfg, sanitize=True)
        st, cl = init_cache(cfg, "cpu"), init_clients(cfg, 4, device="cpu")
        keys = (torch.arange(1, 161).reshape(40, 4) % 23) + 1
        wr = torch.ones_like(keys, dtype=torch.bool)
        wr[20:] = False
        try:
            res_s = sanitize.checked(
                lambda: _run_trace_impl(scfg, st, cl, keys, wr))()
        except Exception as e:
            out.append(f"sanitize-smoke[{backend}]: clean trace raised: "
                       f"{str(e).splitlines()[0]}")
            continue
        res_p = _run_trace_impl(cfg, st, cl, keys, wr)
        from torch.utils._pytree import tree_leaves
        for a, b in zip(tree_leaves(res_s), tree_leaves(res_p)):
            if not torch.equal(a, b):
                out.append(f"sanitize-smoke[{backend}]: sanitize=True "
                           "changed a decision (must be bit-identical)")
                break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files/dirs to AST-lint "
                    "(default: src/repro_torch)")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the audit's and the graph fixtures' tensors")
    ap.add_argument("--plan-check", action="store_true")
    ap.add_argument("--sanitize-smoke", action="store_true")
    ap.add_argument("--no-astlint", action="store_true",
                    help="skip the AST pass (run only the selected extras)")
    ap.add_argument("--demo", metavar="RULE")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis import all_rules
    rules = all_rules()

    if args.list_rules:
        for rid in sorted(rules):
            print(f"{rid}  {rules[rid]}")
        return 0

    if args.demo:
        rid = args.demo.upper()
        if rid not in rules:
            print(f"unknown rule {rid!r}", file=sys.stderr)
            return 2
        found = run_demo(rid, args.device)
        for f in found:
            print(f)
        if found:
            print(f"--demo {rid}: rule fired on its seeded fixture "
                  "(exit 1, as intended)")
            return 1
        print(f"--demo {rid}: rule did NOT fire: fixture or rule broken",
              file=sys.stderr)
        return 3

    if args.selftest:
        broken = []
        for rid in sorted(rules):
            fired = run_demo(rid, args.device)
            print(f"{rid}: {'fired' if fired else 'DID NOT FIRE'}")
            if not fired:
                broken.append(rid)
        if broken:
            print(f"selftest FAILED: {', '.join(broken)}", file=sys.stderr)
            return 1
        print(f"selftest OK: all {len(rules)} rules fire on their fixtures")
        return 0

    findings = []
    if not args.no_astlint:
        findings += run_astlint(args.paths or [str(SRC)])
    if args.plan_check:
        findings += run_plan_check()
    if args.audit:
        findings += run_audit(args.device)
    if args.sanitize_smoke:
        findings += run_sanitize_smoke()

    for f in findings:
        print(f)
    if findings:
        print(f"dittolint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("dittolint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
