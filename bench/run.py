"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its metrics are named in
``BENCHMARK.json`` at the root of the checkout.  The run measures the
PyTorch and CUDA port (``src/repro_torch``) on the cards of this machine;
it exits non-zero and prints no result without enough of them, or if the
process has loaded JAX or the JAX package by the window's close.  The
numbers the check compares are printed beside their limits, as the last
lines of standard error and under ``checks`` in the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches of compilers the program might reach, at fixed paths inside the
# checkout (the program's own nvcc build lives in its package).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench" / "_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "bench" / "_cache" /
                                         "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# Top-level module names that must not be loaded: JAX, and the JAX package
# the port was made from (``repro``; the port is ``repro_torch``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import spec
    from bench.harness.cell import log, run_cell

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"this machine has {n}")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    loaded = sorted(m for m in FORBIDDEN if m in sys.modules)
    if loaded:
        log(f"the run loaded {loaded}; the benchmark measures the port only")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
