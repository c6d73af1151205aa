"""Launcher of the ``drop_scatter`` CUDA kernel (``csrc/drop_scatter.cu``):
the cache step's in-place row writes, several columns to one index array,
out-of-range indices dropped.

It takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain version is ``kernels/ref.py::
drop_scatter_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

MAX_COLS = 12   # csrc/drop_scatter.cu's MAX_COLS


def drop_scatter(idx, cols, srcs) -> None:
    """For each column, ``col[idx[b]] = src[b]`` (a row, or the number
    ``src``) where ``0 <= idx[b] < len(col)``; nothing elsewhere."""
    k = len(cols)
    dev = idx.device
    dst = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    src = (ctypes.c_void_p * k)(*[s.data_ptr() if torch.is_tensor(s) else None
                                  for s in srcs])
    fill = (ctypes.c_longlong * k)(*[0 if torch.is_tensor(s) else int(s)
                                     for s in srcs])
    width = (ctypes.c_int * k)(*[c[0].numel() for c in cols])
    word = (ctypes.c_int * k)(*[c.element_size() for c in cols])
    err = runtime.lib().drop_scatter_launch(
        idx.data_ptr(), idx.shape[0], cols[0].shape[0], k, dst, src, fill,
        width, word, runtime.counter("drop_scatter", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "drop_scatter")
