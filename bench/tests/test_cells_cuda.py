"""On the card: each cell at its own size through the whole harness for a
short window, and the control there.  Skipped without a card; run on the
card with ``python3 -m pytest -q --noconftest -m cuda bench/tests``."""

from __future__ import annotations

import json

import pytest

from bench import controls
from bench.harness import spec
from bench.harness.cell import run_cell

CELLS = tuple(w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"])


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, name):
    out = run_cell(spec.load_cell(name), 6_000_000_011, 3.0, False,
                   device=card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["requests_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = spec.load_cell(name)
    limits = cell["config"]["check"]["limits"]
    got = controls.readings(cell, 7_000_000_001,
                            cell["config"]["check"]["calls"], card,
                            ("sound", "control"))
    assert all(got["sound"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())
