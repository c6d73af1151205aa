"""The plain reference against a tiny CPU run of the port, through the
whole harness, and the control and faults of ``bench/controls.py`` at
that size: each must fail a number the check compares."""

from __future__ import annotations

import pytest

from bench import controls
from bench.harness.cell import run_cell
from bench.tests.tiny import tiny_cell

CELLS = ("pool2m-ycsb-a", "dm8x8-ycsb-a", "pool2m-ycsb-c-fit")


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_of_the_port_matches_the_reference(name):
    out = run_cell(tiny_cell(name), 3_000_000_019, 0.0, False,
                   device="cpu", max_calls=3)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["attempted"] == 3 * 32 * 64
    assert set(out["metrics"]) == {"requests_per_s", "latency_p95_ms",
                                   "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"


# The control and the contract's faults, which every cell must catch.
MUST_FAIL = ("control", "state_unchanged", "half_batch", "answer_altered")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_fail_and_every_number_can(name):
    cell = tiny_cell(name)
    limits = cell["config"]["check"]["limits"]
    got = controls.readings(cell, 4_000_000_007, 2, "cpu")
    assert all(got["sound"][k] <= v for k, v in limits.items())
    dm = cell["config"]["kind"] == "dm"
    assert ("exchange_left_out" in got) == dm
    assert ("plan_unchecked" in got) != dm
    for variant in MUST_FAIL + (("exchange_left_out",) if dm else ()):
        assert any(got[variant][k] > v for k, v in limits.items()), variant
    # The control reads above every number's limit: its readings are the
    # upper ones the limits are set below.
    assert all(got["control"][k] > v for k, v in limits.items())
