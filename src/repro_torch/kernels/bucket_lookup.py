"""Launchers of the bucket-probe CUDA kernels: ``access_probe``
(``csrc/access_probe.cu``), the Get-path probe with the embedded-history
match and, for the cache step, the insert path's facts about the same
bucket, and ``bucket_lookup`` (``csrc/bucket_lookup.cu``), the probe
alone.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are ``kernels/ref.py::
access_probe_ref`` and ``bucket_lookup_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import ProbeFacts
from repro_torch.kernels.sampled_eviction import expert_codes


def access_probe(table_key, table_size, table_hash, table_ptr, keys,
                 hist_ctr, *, assoc: int, history_len: int, meta=None,
                 ts=None, experts=None):
    """Returns (found bool[B], slot i64[B] (-1 miss), hist_found bool[B],
    hist_slot i64[B]), and with ``meta`` (the table's insert_ts, last_ts
    and freq), ``ts`` and ``experts`` the bucket's :class:`ProbeFacts`
    as a fifth."""
    B = keys.shape[0]
    dev = keys.device
    i64 = lambda *shape: torch.empty(shape, dtype=torch.int64, device=dev)
    flag = lambda: torch.empty(B, dtype=torch.bool, device=dev)
    found, slot, hfound, hslot = flag(), i64(B), flag(), i64(B)
    # The facts' arguments: (insert_ts, last_ts, freq, ts, codes), E and
    # the eight outputs; null pointers and E = 0 for the probe alone.
    facts = None
    ptrs = [None] * 5 + [0] + [None] * 8
    if meta is not None:
        E = len(experts)
        facts = ProbeFacts(key_hash=i64(B), bucket=i64(B), free_slot=i64(B),
                           has_free=flag(), hist_slot=i64(B),
                           has_hist=flag(), has_live=flag(),
                           cand=i64(B, E + 1))
        ptrs = ([m.data_ptr() for m in meta]
                + [ts.data_ptr(), expert_codes(experts, dev).data_ptr(), E]
                + [t.data_ptr() for t in facts])
    err = runtime.lib().access_probe_launch(
        table_key.data_ptr(), table_size.data_ptr(), table_hash.data_ptr(),
        table_ptr.data_ptr(), keys.data_ptr(), hist_ctr.data_ptr(), B, assoc,
        table_key.shape[0] // assoc, history_len, found.data_ptr(),
        slot.data_ptr(), hfound.data_ptr(), hslot.data_ptr(), *ptrs,
        runtime.counter("access_probe", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "access_probe")
    out = (found, slot, hfound, hslot)
    return out if facts is None else out + (facts,)


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
