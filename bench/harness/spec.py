"""The cell a run measures, read from ``BENCHMARK.json`` and the data
files it names: a configuration (``configs[].file``), a traffic mix
(``bench/traffic/<traffic>.json``) and the metrics the cell reports.
Per-layer metrics are readers found by name, ``bench/metrics/<name>.py``,
each with a ``read(ctx)`` that returns a number or None."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs, as plain data."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return assemble(name, root / conf["file"], cell["traffic"],
                    int(cell["chips"]),
                    [m for m in spec["end_to_end"] if _applies(m, name)],
                    [m for m in spec["per_layer"] if _applies(m, name)])


def assemble(name: str, config_file: Path, traffic: str, chips: int = 1,
             end_to_end=(), per_layer=()) -> dict:
    """A cell from a configuration file and the name of a traffic mix."""
    config = json.loads(Path(config_file).read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return dict(name=name, chips=chips, config=config, mix=mix,
                end_to_end=list(end_to_end), per_layer=list(per_layer))


def reader(metric_name: str, bench: Path = BENCH):
    """The ``read`` function of ``bench/metrics/<metric_name>.py``."""
    path = bench / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric_name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
