"""``bench/profile_spans.py``'s reduction of a profile with the
program's spans, on a synthetic trace whose numbers are worked by hand:
two calls, nested spans, a shadow over two overlapping kernels, a kernel
that outlasts its shadow, a copy that is no kernel, and device work past
the calls' extent."""

from __future__ import annotations

import pytest

from bench.profile_spans import BETWEEN, metrics, split

CALLS = [(0, 100), (120, 200)]
HOST = [(5, 95, "ditto.execute"), (10, 20, "ditto.plan"),
        (30, 60, "ditto.scan.step"), (70, 90, "ditto.readback"),
        (125, 195, "ditto.execute"), (130, 170, "ditto.scan.step")]
SHADOWS = [(32, 58, "ditto.scan.step"), (72, 80, "ditto.readback"),
           (132, 168, "ditto.scan.step")]
DEV = [(32, 40, "k1"), (38, 50, "k2"), (55, 65, "k3"),
       (72, 78, "Memcpy DtoH (Device -> Pinned)"), (132, 140, "k4"),
       (195, 210, "k5")]
NS = 1e-9


def test_split_reads_the_spans_their_shadows_and_the_idle_time():
    r = split(DEV, HOST, SHADOWS, CALLS)
    assert r["window_s"] == pytest.approx(200 * NS)
    assert r["busy_s"] == pytest.approx(47 * NS)    # 18 + 10 + 6 + 8 + 5
    assert r["calls"] == 2
    sp = r["spans"]
    assert sp["ditto.execute"] == pytest.approx(
        dict(count=2, host_s=160 * NS, busy_s=0.0, kernels=0))
    assert sp["ditto.plan"] == pytest.approx(
        dict(count=1, host_s=10 * NS, busy_s=0.0, kernels=0))
    assert sp["ditto.readback"] == pytest.approx(
        dict(count=1, host_s=20 * NS, busy_s=6 * NS, kernels=0))
    # k1 and k2 overlap (18 ns once), k3 is clipped at the shadow's end.
    assert sp["ditto.scan.step"] == pytest.approx(
        dict(count=2, host_s=70 * NS, busy_s=29 * NS, kernels=4))
    assert r["execute_idle_s"] == pytest.approx(118 * NS)
    idle = dict(r["idle_by_span"])
    assert [k for k, _ in r["idle_by_span"]] == [
        "ditto.execute", "ditto.scan.step", BETWEEN, "ditto.readback",
        "ditto.plan"]
    assert idle == pytest.approx({
        "ditto.execute": 55 * NS, "ditto.scan.step": 39 * NS,
        BETWEEN: 35 * NS, "ditto.readback": 14 * NS, "ditto.plan": 10 * NS})
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])


def test_metrics_of_a_profile_and_their_none_cases():
    m = metrics(split(DEV, HOST, SHADOWS, CALLS))
    assert m == pytest.approx(dict(
        carry_copy_ms_per_call=None, graph_replay_us_per_step=29e-3 / 2,
        graph_kernels_per_step=2.0, execute_idle_share=59.0,
        device_idle_share=76.5))
    bare = metrics(split(DEV, [], [], CALLS))
    assert bare == pytest.approx(dict(
        carry_copy_ms_per_call=None, graph_replay_us_per_step=None,
        graph_kernels_per_step=None, execute_idle_share=None,
        device_idle_share=76.5))
    assert bare["device_idle_share"] == metrics(
        split(DEV, HOST, SHADOWS, CALLS))["device_idle_share"]
    assert split(DEV, HOST, SHADOWS, []) is None


def test_the_copies_are_read_per_call():
    host = HOST + [(22, 28, "ditto.scan.copy_in"),
                   (62, 68, "ditto.scan.copy_out")]
    shadows = SHADOWS + [(22, 28, "ditto.scan.copy_in"),
                         (62, 68, "ditto.scan.copy_out")]
    dev = DEV + [(22, 27, "Memcpy DtoD (Device -> Device)")]
    r = split(dev, host, shadows, CALLS)
    # copy_in: 5 ns; copy_out: the 3 ns of k3 inside its shadow (62..65),
    # a kernel that started before it and so is none of its kernels.
    assert metrics(r)["carry_copy_ms_per_call"] == pytest.approx(
        1e3 * (5 + 3) * NS / 2)
    assert r["spans"]["ditto.scan.copy_out"]["kernels"] == 0
