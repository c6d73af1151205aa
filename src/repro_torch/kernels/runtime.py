"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` compile with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3`` (one ``nvcc`` process per source, all started together) and link
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``_build/`` beside this module (listed
in ``.gitignore``), keyed by a hash of the sources, the shared device
code they include (``csrc/*.cuh``) and the flags, so an unchanged
checkout builds once.  It holds a file lock (:func:`build_lock`), so
processes that start together (the ranks of a DM pool, a user's
``torchrun``) build one at a time and the later ones load what the first
built.  No ``--use_fast_math``: it would turn
``exp2f`` and division into approximations, and the f32 priorities must
round as the plain PyTorch versions' do.

Each C entry point returns ``cudaGetLastError()``; :func:`check` raises
if it is non-zero.  Each kernel adds one to its launch counter, an int64
on the device that the launcher passes by pointer (:func:`counter`), from
one thread of the launch: a launch replayed from a captured CUDA graph
is counted as one made from Python is, and nothing else is.
:func:`device_line` gives the card's name and power limit, which every
number taken on the card is printed beside.  Nothing
here runs at import time: the CPU tests import every module without a
compiler or a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as void*).
SIGNATURES = {
    "access_probe_launch": [P, P, P, P, P, P, I, I, L, L, P, P, P, P, P, P,
                            P, P, P, I, P, P, P, P, P, P, P, P, P, P],
    "hit_metadata_update_launch": [P, P, P, P, P, I, P, P, I, P, P, P, P, P],
    "ranked_eviction_launch": [P, P, P, P, P, L, P, P, P, P, I, P, P, L, I, I,
                               I, I, P, P, P, P, P, P],
    "ranked_eviction_draw_launch": [P, P, P, P, P, L, P, I, P, P, I, P, P, I,
                                    P, P, L, I, I, I, I, P, P, P, P, P, P,
                                    P, P],
    "flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L,
                               L, L, L, L, L, P, P],
    "sampled_eviction_launch": [P, P, P, P, L, P, P, P, F, L, I, I, I, I, P, P,
                                P, P, P, P],
    "bucket_lookup_launch": [P, P, P, I, I, L, P, P, P, P],
    "metadata_update_launch": [P, P, I, L, P, P, P, F, P, P, P, P],
    "drop_scatter_launch": [I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                            P],
    "launch_floor_launch": [P],
}
KERNELS = ("access_probe", "hit_metadata_update", "ranked_eviction",
           "flash_attention", "sampled_eviction", "bucket_lookup",
           "metadata_update", "drop_scatter")
# The empty kernel that chip_smoke.py times as the launch floor: no path
# launches it and it has no counter.
FLOOR = "launch_floor"

_LIB = None
_COUNTERS: dict = {}   # device -> int64[len(KERNELS)] launch counts


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def build_lock(build_dir: Path = BUILD_DIR):
    """Hold the exclusive lock of ``build_dir`` (an ``flock`` of its
    ``.lock`` file) for a block: one process at a time builds there.  The
    kernel drops the lock when its holder exits, so a build that was cut
    off leaves no stale lock behind."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile the sources into the keyed shared library (if missing)
    and return its path."""
    srcs = sources()
    lib = BUILD_DIR / f"libditto_kernels_{_digest(srcs)}.so"
    if lib.exists():
        return lib
    with build_lock():
        if not lib.exists():            # another process built it meanwhile
            _compile(srcs, lib)
    return lib


def _compile(srcs, lib: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for s, o in zip(srcs, objs)]
        errors = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{s.name}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib.name
        subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                        *map(str, objs)], check=True, capture_output=True)
        os.replace(tmp_lib, lib)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def counter(name: str, device) -> int:
    """Device address of kernel ``name``'s launch counter on ``device``.
    The counters are made on first use, which must not be inside a CUDA
    graph capture (a captured fill would not have run)."""
    t = _COUNTERS.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counters are made outside a capture: "
                               "run the step once before capturing it")
        t = _COUNTERS[device] = torch.zeros(len(KERNELS), dtype=torch.int64,
                                            device=device)
    return t.data_ptr() + 8 * KERNELS.index(name)


def launch_counts() -> dict:
    """Launches of each kernel on every device since the last
    :func:`reset_counts` (reads the device counters: a host sync)."""
    out = dict.fromkeys(KERNELS, 0)
    for t in _COUNTERS.values():
        # A read outside any step, documented as a host sync.
        for name, n in zip(KERNELS, t.tolist()):  # dittolint: disable=DL001
            out[name] += n
    return out


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for t in _COUNTERS.values():
        t.zero_()


def launch_floor(device) -> None:
    """Launch the empty kernel on ``device``'s current stream."""
    check(lib().launch_floor_launch(torch.cuda.current_stream(device)
                                    .cuda_stream), FLOOR)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
