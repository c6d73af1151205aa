"""Named spans and counters of the program's own host work.

``span(name)`` marks a stretch of host code on ``torch.profiler``'s
timeline (``record_function``), beside the device's events, while a
profiler records; otherwise it costs one check and enters nothing.  The
spans thus exist exactly when someone profiles the program.  Every name
starts with ``ditto.``; a call's spans are those nested inside its
``ditto.execute`` span on one host thread.  No span sits inside a
captured CUDA graph: each wraps host code that launches device work.

``count(name)`` adds to a plain Python counter (no device work, no
sync); ``counters()`` reads them all.  The counters are
``graph_captures``, steps captured as a CUDA graph, and
``donated_scans``, scans that ran in place on a donated table
(``core/cache.py::_scan``).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_COUNTS = {"graph_captures": 0, "donated_scans": 0}


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, a shared no-op otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter, by name."""
    return dict(_COUNTS)
