"""Launchers of the bucket-probe CUDA kernels: ``access_probe``
(``csrc/access_probe.cu``), the Get-path probe with the embedded-history
match, and ``bucket_lookup`` (``csrc/bucket_lookup.cu``), the probe
alone.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are ``kernels/ref.py::
access_probe_ref`` and ``bucket_lookup_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime


def access_probe(table_key, table_size, table_hash, table_ptr, keys,
                 hist_ctr, *, assoc: int, history_len: int):
    """Returns (found bool[B], slot i64[B] (-1 miss), hist_found bool[B],
    hist_slot i64[B])."""
    B = keys.shape[0]
    dev = keys.device
    found = torch.empty(B, dtype=torch.bool, device=dev)
    slot = torch.empty(B, dtype=torch.int64, device=dev)
    hfound = torch.empty(B, dtype=torch.bool, device=dev)
    hslot = torch.empty(B, dtype=torch.int64, device=dev)
    err = runtime.lib().access_probe_launch(
        table_key.data_ptr(), table_size.data_ptr(), table_hash.data_ptr(),
        table_ptr.data_ptr(), keys.data_ptr(), hist_ctr.data_ptr(), B, assoc,
        table_key.shape[0] // assoc, history_len, found.data_ptr(),
        slot.data_ptr(), hfound.data_ptr(), hslot.data_ptr(),
        runtime.counter("access_probe", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "access_probe")
    return found, slot, hfound, hslot


def bucket_lookup(table_key, table_size, keys, *, assoc: int):
    """Returns (found bool[B], slot i64[B] (-1 miss))."""
    B = keys.shape[0]
    dev = keys.device
    found = torch.empty(B, dtype=torch.bool, device=dev)
    slot = torch.empty(B, dtype=torch.int64, device=dev)
    err = runtime.lib().bucket_lookup_launch(
        table_key.data_ptr(), table_size.data_ptr(), keys.data_ptr(), B,
        assoc, table_key.shape[0] // assoc, found.data_ptr(), slot.data_ptr(),
        runtime.counter("bucket_lookup", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "bucket_lookup")
    return found, slot
