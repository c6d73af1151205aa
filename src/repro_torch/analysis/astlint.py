"""dittolint pass 1 for the port: an AST lint of ``src/repro_torch``,
the counterpart of ``repro/analysis/astlint.py`` aimed at torch.  The
rules keep the JAX pass's ids where the bug class carries over:

  DL001  A Python branch on a device value (an ``if``/``while``/
         ``assert`` whose test calls into ``torch``, or a tensor's
         ``any``/``all``/``item``), or a host sync (``.item()``,
         ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool()`` of a torch
         call) in a traced module: the step replays as a CUDA graph,
         which a sync breaks.
  DL002  A ``core/prng.py`` key consumed twice (``uniform``/``split``)
         without a ``split``/``fold_in`` reassignment in between.
  DL003  ``sort``/``argsort``/``topk``/``msort`` in a hot-path module
         (the repo's standard is argmin-peel ranking).
  DL004  ``torch.float64``/``torch.double`` or ``.double()`` in a traced
         module.  int64 is exempt: the port's u32 columns are int64 by
         design (``core/types.py``).
  DL005  A plain version of ``kernels/ref.py`` (a ``*_ref`` function)
         called outside the operators' dispatch (``kernels/library.py``,
         ``kernels/ops.py``) and the tests: a fallback that hides the
         kernel.
  DL006  A mutable default (list/dict/set) in a signature or a
         dataclass field.
  DL007  A direct call to a deprecated execution entry point
         (``run_trace``/``run_trace_grouped``/``dm_access``) outside the
         shims; use ``repro_torch.core.execute``.
  DL008  A direct call to a deprecated membership entry point
         (``dm_make``/``dm_set_capacity``, or ``set_capacity`` with a
         positional ``n_shards``) outside the shims; use
         ``repro_torch.dm.Cluster``.
  DL009  An import of ``jax`` or of the JAX package (``repro.``) inside
         ``src/repro_torch``: the port stands alone.

Escape hatch: ``# dittolint: disable=DL003`` (comma-separate several)
on the flagged line or the line above it, with the reason.  Stdlib
``ast`` only: nothing linted is imported.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Set

RULES: Dict[str, str] = {
    "DL001": "python branch on a device value or a host sync (.item/"
             ".tolist/.cpu/.numpy/bool) in a traced module (breaks CUDA "
             "graph capture)",
    "DL002": "core.prng key consumed more than once without split/fold_in "
             "re-threading (correlated random streams)",
    "DL003": "sort/argsort/topk in a hot-path module (repo standard: "
             "argmin-peel ranking)",
    "DL004": "torch.float64/double in a traced module",
    "DL005": "plain version (kernels/ref.py *_ref) called outside the "
             "operators' dispatch: a fallback that hides the kernel",
    "DL006": "mutable default (list/dict/set) in a function signature or "
             "dataclass field",
    "DL007": "direct call to a deprecated entry point "
             "(run_trace/run_trace_grouped/dm_access); use "
             "repro_torch.core.execute()",
    "DL008": "direct call to a deprecated membership entry point "
             "(dm_make/dm_set_capacity/positional set_capacity); use "
             "repro_torch.dm.Cluster",
    "DL009": "import of jax or of the JAX package (repro.) in the port",
}

# Modules whose code runs in the step, which replays as a CUDA graph on
# the card (the JAX package's jit-traced modules): DL001 and DL004 apply
# here.  The facade (``core/execute.py``), the host-driven drain and
# lane resize and the membership's host numpy run outside the graph.
TRACED_MODULES = ("/core/cache.py", "/core/fc_cache.py", "/core/priority.py",
                  "/core/prng.py", "/core/hashing.py", "/core/u32.py",
                  "/kernels/", "/dm/sharded_cache.py")
# The latency-critical subset: DL003 applies here.
HOT_PATH_MODULES = ("/core/cache.py", "/core/fc_cache.py",
                    "/core/priority.py", "/kernels/", "/dm/")
# The operators' dispatch: the only callers of the plain versions.
DISPATCH_MODULES = ("/kernels/library.py", "/kernels/ops.py",
                    "/kernels/ref.py")
# The legacy execution surface and its deliberate callers.
LEGACY_SHIM_MODULES = ("/core/cache.py", "/core/execute.py",
                       "/core/__init__.py", "/dm/sharded_cache.py",
                       "/dm/__init__.py", "/analysis/")
_DEPRECATED_ENTRYPOINTS = frozenset(
    {"run_trace", "run_trace_grouped", "dm_access"})
MEMBERSHIP_SHIM_MODULES = LEGACY_SHIM_MODULES + ("/dm/cluster.py",
                                                 "/elastic/resize.py")
_MEMBERSHIP_ENTRYPOINTS = frozenset({"dm_make", "dm_set_capacity"})
# Only the port's own tree is held to DL009.
PORT_MODULES = ("/repro_torch/",)

_DISABLE_RE = re.compile(
    r"#.*dittolint:\s*disable=([A-Z0-9_]+(?:\s*,\s*[A-Z0-9_]+)*)")
_KEY_CONSUMERS = frozenset({"uniform", "split"})
_SORT_NAMES = frozenset({"argsort", "sort", "topk", "msort"})
_SYNCS = frozenset({"item", "tolist", "cpu", "numpy"})
_BRANCH_METHODS = frozenset({"any", "all", "item"})
_WIDE = frozenset({"float64", "double"})


class Finding(NamedTuple):
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# torch calls that answer on the host: no device value.
_HOST_TORCH = ("torch.is_", "torch.cuda.", "torch.device", "torch.get_",
               "torch.promote_types", "torch.finfo", "torch.iinfo",
               "torch.Size", "torch.backends.")


def _is_device_call(node: ast.AST) -> bool:
    """True if the subtree calls into ``torch`` (but its host queries) or
    a tensor's any/all/item."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = _attr_chain(sub.func)
            if (chain.split(".")[0] == "torch"
                    and not chain.startswith(_HOST_TORCH)):
                return True
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _BRANCH_METHODS):
                return True
    return False


def _disabled(source: str) -> Dict[int, Set[str]]:
    """Line -> suppressed rule ids: a disable comment covers its own line
    and the line after it."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            out.setdefault(i + 1, set()).update(rules)
    return out


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        return _attr_chain(node.func) in ("list", "dict", "set")
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, in_tests: bool):
        self.path = path
        norm = "/" + path.replace("\\", "/")
        has = lambda mods: any(m in norm for m in mods)
        self.traced = has(TRACED_MODULES)
        self.hot = has(HOT_PATH_MODULES)
        self.dispatch_ok = in_tests or has(DISPATCH_MODULES)
        self.legacy_ok = in_tests or has(LEGACY_SHIM_MODULES)
        self.membership_ok = in_tests or has(MEMBERSHIP_SHIM_MODULES)
        self.port = has(PORT_MODULES)
        self.findings: List[Finding] = []

    def flag(self, node: ast.AST, rule: str, detail: str = "") -> None:
        msg = RULES[rule] + (f" [{detail}]" if detail else "")
        self.findings.append(Finding(self.path, node.lineno, rule, msg))

    # -- DL001: branches on device values -------------------------------
    def _check_branch(self, node, test) -> None:
        if self.traced and _is_device_call(test):
            self.flag(node, "DL001", "branch")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    # -- DL009: imports -------------------------------------------------
    def _check_import(self, node, name: str) -> None:
        if self.port and (name == "jax" or name.startswith("jax.")
                          or name == "repro" or name.startswith("repro.")):
            self.flag(node, "DL009", name)

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self._check_import(node, a.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level == 0 and node.module:
            self._check_import(node, node.module)
        self.generic_visit(node)

    # -- DL002: key reuse / DL006: mutable defaults ---------------------
    def _check_key_reuse(self, fn) -> None:
        """Line-ordered scan of one function body: the same name consumed
        twice by ``prng.uniform``/``prng.split`` without a reassignment
        in between."""
        def walk_shallow(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                yield child
                yield from walk_shallow(child)

        events = []
        for sub in walk_shallow(fn):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func)
                leaf = chain.rsplit(".", 1)[-1]
                if (chain.startswith("prng.") and leaf in _KEY_CONSUMERS
                        and sub.args and isinstance(sub.args[0], ast.Name)):
                    events.append((sub.lineno, 0, "consume",
                                   sub.args[0].id, sub))
            for tgt in self._assign_targets(sub):
                events.append((tgt.lineno, 1, "assign", tgt.id, tgt))
        events.sort(key=lambda e: (e[0], e[1]))
        consumed: Dict[str, int] = {}
        for line, _, kind, name, node in events:
            if kind == "assign":
                consumed.pop(name, None)
            elif name in consumed:
                self.flag(node, "DL002", f"key '{name}' already consumed "
                          f"on line {consumed[name]}")
            else:
                consumed[name] = line

    @staticmethod
    def _assign_targets(node):
        tgts = []
        if isinstance(node, ast.Assign):
            tgts = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            tgts = [node.target]
        return [s for t in tgts for s in ast.walk(t)
                if isinstance(s, ast.Name)]

    def _check_fn(self, node) -> None:
        self._check_key_reuse(node)
        args = node.args
        names = ([a.arg for a in args.args][-len(args.defaults):]
                 if args.defaults else [])
        names += [a.arg for a in args.kwonlyargs]
        for name, d in zip(names, list(args.defaults) + args.kw_defaults):
            if d is not None and _is_mutable_literal(d):
                self.flag(d, "DL006", f"arg '{name}'")

    def visit_FunctionDef(self, node) -> None:
        self._check_fn(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._check_fn(node)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        deco = {_attr_chain(d.func if isinstance(d, ast.Call) else d)
                .rsplit(".", 1)[-1] for d in node.decorator_list}
        if "dataclass" in deco:
            for stmt in node.body:
                val = getattr(stmt, "value", None)
                if (isinstance(stmt, (ast.Assign, ast.AnnAssign))
                        and val is not None and _is_mutable_literal(val)):
                    self.flag(stmt, "DL006", f"dataclass '{node.name}'")
        self.generic_visit(node)

    # -- DL001 syncs / DL003 / DL004 / DL005 / DL007 / DL008 on calls ---
    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                else chain)
        if self.traced and isinstance(node.func, ast.Attribute) \
                and leaf in _SYNCS and not node.args:
            self.flag(node, "DL001", f".{leaf}()")
        if self.traced and chain == "bool" and node.args \
                and _is_device_call(node.args[0]):
            self.flag(node, "DL001", "bool()")
        if self.hot and leaf in _SORT_NAMES:
            self.flag(node, "DL003", chain or leaf)
        if self.traced and leaf == "double" and not node.args:
            self.flag(node, "DL004", ".double()")
        if (not self.dispatch_ok and leaf.endswith("_ref")
                and (chain.startswith(("ref.", "kref.")) or chain == leaf)):
            self.flag(node, "DL005", chain)
        if leaf in _DEPRECATED_ENTRYPOINTS and not self.legacy_ok:
            self.flag(node, "DL007", chain or leaf)
        if not self.membership_ok:
            if leaf in _MEMBERSHIP_ENTRYPOINTS:
                self.flag(node, "DL008", chain or leaf)
            elif leaf == "set_capacity" and len(node.args) >= 3:
                self.flag(node, "DL008",
                          f"{chain or leaf} with positional n_shards")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        chain = _attr_chain(node)
        if self.traced and chain.startswith("torch.") \
                and chain.rsplit(".", 1)[-1] in _WIDE:
            self.flag(node, "DL004", chain)
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one python source string; returns enabled findings only."""
    in_tests = ("tests/" in path.replace("\\", "/")
                or Path(path).name.startswith("test_"))
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "DL000",
                        f"syntax error: {e.msg}")]
    linter = _Linter(path, in_tests)
    linter.visit(tree)
    off = _disabled(source)
    return sorted(
        (f for f in linter.findings if f.rule not in off.get(f.line, ())),
        key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories
    (``tests/`` excluded: fixtures there break rules on purpose)."""
    findings: List[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            rel = f.as_posix()
            if "/tests/" in f"/{rel}" or f.name.startswith("test_"):
                continue
            findings.extend(lint_source(f.read_text(), rel))
    return findings
