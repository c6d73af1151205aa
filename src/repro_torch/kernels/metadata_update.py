"""Launcher of the ``hit_metadata_update`` CUDA kernel
(``csrc/hit_metadata_update.cu``): last_ts / ext at hit slots, the
FC-cache freq FAA at flush slots.

The outputs are fresh tensors (copies of the step-entry columns, then
updated): the eviction later in the step reads the step-entry table.
Takes CUDA tensors already checked by ``kernels/ops.py``; the plain
version is ``kernels/ref.py::hit_metadata_update_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime


def hit_metadata_update(freq, last_ts, ext, hit_slots, hit_ts, emit_slots,
                        emit_deltas):
    """Returns updated (freq, last_ts, ext), each a new tensor."""
    out = (freq.clone(), last_ts.clone(), ext.clone())
    hit_metadata_update_into(freq, last_ts, ext, hit_slots, hit_ts,
                             emit_slots, emit_deltas, *out)
    return out


def hit_metadata_update_into(freq, last_ts, ext, hit_slots, hit_ts,
                             emit_slots, emit_deltas, freq_out, last_out,
                             ext_out) -> None:
    """The kernel's passes alone: update ``*_out``, which hold a copy of
    the step-entry columns, at the hit and flush slots."""
    C = freq.shape[0]
    dev = freq.device
    ts_eff = torch.empty(C, dtype=torch.int32, device=dev)
    claim = torch.empty(C, dtype=torch.int32, device=dev)
    err = runtime.lib().hit_metadata_update_launch(
        freq.data_ptr(), last_ts.data_ptr(), ext.data_ptr(),
        hit_slots.data_ptr(), hit_ts.data_ptr(), hit_slots.shape[0],
        emit_slots.data_ptr(), emit_deltas.data_ptr(), emit_slots.shape[0],
        ts_eff.data_ptr(), claim.data_ptr(), freq_out.data_ptr(),
        last_out.data_ptr(), ext_out.data_ptr(),
        runtime.counter("hit_metadata_update", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "hit_metadata_update")
