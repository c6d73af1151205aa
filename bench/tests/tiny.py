"""The benchmark's cells cut to a size the CPU tests hold: the same
configuration files and mixes, with a 4,096-slot table (capacity 1,024)
of 2-word values loaded with 1,152 keys, 20,000 keys, calls of a few
rows and checked runs of 2 calls."""

from __future__ import annotations

from bench.harness import spec

# A DM configuration no cell runs yet (PERF.md, Open questions): its kind
# and reference are held to the port here.
DM = ("dm8x8-ycsb-a", "dm-8x8", "ycsb-a-10m-depth1")


def tiny_cell(name: str, rows: int = 32) -> dict:
    if name == DM[0]:
        cell = spec.assemble(name, spec.BENCH / "configs" / f"{DM[1]}.json",
                             DM[2])
        cell["end_to_end"] = spec.load_cell("pool2m-ycsb-a")["end_to_end"]
    else:
        cell = spec.load_cell(name)
    cell["config"]["cache"].update(n_buckets=512, capacity=1024,
                                   value_words=2)
    cell["config"]["check"].update(cases=1, calls=2)
    cell["mix"].update(n_keys=20_000, pool_requests=64 * 256,
                       rows_per_call=rows, load_keys=1152,
                       warm_calls=1, trace_calls=2)
    if cell["config"]["kind"] == "dm":
        cell["config"]["rounds_per_group"] = 32
    return cell
