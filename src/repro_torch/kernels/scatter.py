"""Launcher of the ``drop_scatter`` CUDA kernel (``csrc/drop_scatter.cu``):
the cache step's in-place row writes, an ordered list of write groups in
one launch, each several columns to one index array, out-of-range and
masked entries dropped.

It takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain version is ``kernels/ref.py::
drop_scatter_groups_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

MAX_GROUPS = 4   # csrc/drop_scatter.cu's MAX_GROUPS
MAX_COLS = 16    # and MAX_COLS, over all groups

# Per device, the kernel's group-ordering counters (csrc/drop_scatter.cu's
# sync[]): zero between launches, since each launch's last block resets
# them.
_SYNC: dict = {}


def _sync(device) -> int:
    t = _SYNC.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("drop_scatter's counters are made outside a "
                               "capture: run the step once before capturing "
                               "it")
        t = _SYNC[device] = torch.zeros(2 + MAX_GROUPS, dtype=torch.int32,
                                        device=device)
    return t.data_ptr()


def _part(x):
    """(pointer, fill) of a source part: a tensor or a number."""
    return (x.data_ptr(), 0) if torch.is_tensor(x) else (None, int(x))


def drop_scatter(groups) -> None:
    """Each group ``(idx, cols, srcs, mask)`` in order: for each column,
    ``col[idx[b]] = src[b]`` where ``0 <= idx[b] < len(col)`` and
    ``mask[b]`` (if not None); a source is a tensor, a number, or
    ``(cond, a, b)``."""
    dev = groups[0][0].device
    cols = [(c, s if isinstance(s, tuple) else (None, s, 0))
            for _, cs, ss, _ in groups for c, s in zip(cs, ss)]
    arr = lambda t, xs: (t * len(xs))(*xs)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    a = [_part(s[1]) for _, s in cols]
    b = [_part(s[2]) for _, s in cols]
    err = runtime.lib().drop_scatter_launch(
        len(groups), arr(P, [g[0].data_ptr() for g in groups]),
        arr(P, [None if g[3] is None else g[3].data_ptr() for g in groups]),
        arr(I, [g[0].shape[0] for g in groups]),
        arr(L, [g[1][0].shape[0] for g in groups]),
        arr(I, [len(g[1]) for g in groups]),
        arr(P, [c.data_ptr() for c, _ in cols]),
        arr(I, [c[0].numel() for c, _ in cols]),
        arr(I, [c.element_size() for c, _ in cols]),
        arr(P, [None if s[0] is None else s[0].data_ptr() for _, s in cols]),
        arr(P, [p for p, _ in a]), arr(L, [f for _, f in a]),
        arr(P, [p for p, _ in b]), arr(L, [f for _, f in b]), _sync(dev),
        runtime.counter("drop_scatter", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "drop_scatter")
