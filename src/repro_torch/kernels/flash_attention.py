"""Launcher of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``): causal softmax attention, forward.

Takes CUDA tensors already checked by
``kernels/ops.py::flash_attention_op``; the plain version is
``kernels/ref.py::flash_attention_ref``.  k and v may be the GQA view
``[B, T, Hkv, R, D]`` that ``models/attention.py::repeat_kv`` makes
(stride 0 on R): no copy is made.  The bf16 kernel reads every tensor
through a TMA tensor map, built for each call from its storage and
strides, so it takes what a map can describe: a 16-byte aligned start,
and strides that are multiples of 16 bytes (8 elements) and nonzero on
every axis of more than one element but R.  It raises on anything
else; the f32 kernel reads through plain element strides.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime

HEAD_DIMS = (32, 64, 128, 256)


def _check_tensor_map(name, x):
    """Raise unless the bf16 kernel's tensor map can describe x
    ([B, T, G, R, D], R's stride 0 or not)."""
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                         "for its tensor map")
    for ax, (st, n) in enumerate(zip(x.stride()[:-1], x.shape[:-1])):
        if n == 1:
            continue
        if st % 8:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned with strides a multiple of 8 elements "
                             f"for its tensor map (axis {ax}: stride {st})")
        if st == 0 and ax != 3:
            raise ValueError(f"flash_attention: {name} has stride 0 on axis "
                             f"{ax}, which a tensor map cannot describe")


def flash_attention(q, k, v):
    """q [B, T, H, D]; k, v [B, T, H, D] or [B, T, Hkv, R, D].
    Returns a new contiguous [B, T, H, D] tensor in q's dtype."""
    B, T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}; the kernel "
                         f"takes {HEAD_DIMS}")
    k5, v5 = (x if x.dim() == 5 else x[:, :, :, None, :] for x in (k, v))
    for name, x in (("q", q[:, :, :, None, :]), ("k", k5), ("v", v5)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension "
                             "must have stride 1")
        if q.dtype == torch.bfloat16:
            _check_tensor_map(name, x)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dev = q.device
    err = runtime.lib().flash_attention_launch(
        q.data_ptr(), k5.data_ptr(), v5.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.float32), B, T, H, D, k5.shape[3],
        *q.stride()[:3], *k5.stride()[:4], *v5.stride()[:4],
        runtime.counter("flash_attention", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "flash_attention")
    return out
