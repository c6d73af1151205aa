"""The port's AST lint (``repro_torch.analysis.astlint``) and the
``python -m repro_torch.analysis`` CLI.

* each DL rule fires on its seeded fixture and stays quiet on a clean
  twin of it; the escape comment silences a finding; a syntax error is
  reported (DL000);
* the shipped port tree lints clean;
* the CLI's exit codes are ``scripts/dittolint.py``'s: 0 clean or
  selftest passed, 1 findings (or a fixture that fires under --demo),
  2 a usage error, 3 a fixture that does not fire under --demo.
"""

from pathlib import Path

import pytest

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import all_rules, astlint

ROOT = Path(__file__).resolve().parents[1]

# A clean twin of each fixture: the same code, the bug class fixed.
CLEAN = {
    "DL001": ("src/repro_torch/core/cache.py",
              "import torch\n"
              "def f(x, n: int):\n"
              "    if n > 0 and torch.is_tensor(x):\n"
              "        return torch.where(x > 0, x, 0)\n"
              "    return x\n"),
    "DL002": ("src/repro_torch/core/cache.py",
              "from repro_torch.core import prng\n"
              "def f(key):\n"
              "    a = prng.uniform(key, 4)\n"
              "    key = prng.fold_in(key, a)\n"
              "    b = prng.uniform(key, 4)\n"
              "    return a + b\n"),
    "DL003": ("src/repro_torch/kernels/_fixture.py",
              "import torch\n"
              "def rank(x):\n"
              "    return torch.argmin(x)\n"),
    "DL004": ("src/repro_torch/core/cache.py",
              "import torch\n"
              "def f(x):\n"
              "    return x.to(torch.int64) + x.to(torch.float32)\n"),
    "DL005": ("src/repro_torch/core/cache.py",
              "from repro_torch.kernels import ops\n"
              "def f(k, s, keys):\n"
              "    return ops.bucket_lookup_op(k, s, keys, assoc=8)\n"),
    "DL006": ("src/repro_torch/core/cache.py",
              "def f(x, acc=None):\n"
              "    acc = [] if acc is None else acc\n"
              "    acc.append(x)\n"
              "    return acc\n"),
    "DL007": ("src/repro_torch/workloads/_fixture.py",
              "from repro_torch.core import execute\n"
              "def f(cache, trace):\n"
              "    return execute(cache, trace, plan=None)\n"),
    "DL008": ("src/repro_torch/workloads/_fixture.py",
              "from repro_torch.dm import Cluster\n"
              "def f(cfg):\n"
              "    cl = Cluster.make(cfg, 8, 8, device='cpu')\n"
              "    return cl.with_capacity(1024)\n"),
    "DL009": ("src/repro_torch/models/_fixture.py",
              "import torch\n"
              "from repro_torch.core import cache\n"),
}

AST_RULES = sorted(r for r in all_rules() if r.startswith("DL"))


@pytest.mark.parametrize("rule", AST_RULES)
def test_each_rule_fires_on_its_fixture_and_not_on_its_twin(rule):
    assert cli.run_demo(rule), rule
    path, src = CLEAN[rule]
    assert [f for f in astlint.lint_source(src, path) if f.rule == rule] == []


def test_rules_keep_their_scope():
    path, src = cli._AST_FIXTURES["DL003"]
    # A sort outside the hot path, an f64 outside the step, a plain
    # version inside the dispatch and an import of JAX outside the port
    # are not findings.
    assert not astlint.lint_source(src, "src/repro_torch/models/moe.py")
    assert not astlint.lint_source(cli._AST_FIXTURES["DL004"][1],
                                   "src/repro_torch/launch/dryrun.py")
    assert not astlint.lint_source(cli._AST_FIXTURES["DL005"][1],
                                   "src/repro_torch/kernels/library.py")
    assert not astlint.lint_source(cli._AST_FIXTURES["DL009"][1],
                                   "tests/test_torch_x.py")


def test_escape_comment_and_syntax_error():
    src = ("import torch\n"
           "def rank(x):\n"
           "    return torch.argsort(x)  # dittolint: disable=DL003\n"
           "def rank2(x):\n"
           "    # a sort of B entries.  dittolint: disable=DL003\n"
           "    return torch.sort(x)\n"
           "def rank3(x):\n"
           "    return torch.sort(x)  # dittolint: disable=DL001\n")
    found = astlint.lint_source(src, "src/repro_torch/kernels/_x.py")
    assert [(f.rule, f.line) for f in found] == [("DL003", 8)]
    bad = astlint.lint_source("def f(:\n", "src/repro_torch/core/x.py")
    assert [f.rule for f in bad] == ["DL000"]


def test_shipped_port_tree_is_clean():
    assert astlint.lint_paths([ROOT / "src" / "repro_torch"]) == []


def test_cli_exit_codes(capsys, monkeypatch):
    assert cli.main([str(ROOT / "src" / "repro_torch")]) == 0
    assert cli.main(["--list-rules"]) == 0
    assert "DL009" in capsys.readouterr().out
    assert cli.main(["--demo", "DL003"]) == 1
    assert cli.main(["--demo", "XX999"]) == 2
    bad = ROOT / "src" / "repro_torch" / "core" / "cache.py"
    monkeypatch.setattr(astlint, "lint_paths", lambda paths: [
        astlint.Finding(str(bad), 1, "DL003", "seeded")])
    assert cli.main([]) == 1
    monkeypatch.setattr(cli, "run_demo", lambda rule, device="cpu": [])
    assert cli.main(["--demo", "DL001"]) == 3
    assert cli.main(["--selftest"]) == 1
    with pytest.raises(SystemExit) as e:
        cli.main(["--no-such-flag"])
    assert e.value.code == 2
