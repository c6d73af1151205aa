"""Launchers of the metadata-update CUDA kernels: ``hit_metadata_update_``
(``csrc/hit_metadata_update.cu``), last_ts / ext at hit slots and the
FC-cache freq FAA at flush slots, in place in the table's columns, and
``metadata_update`` (``csrc/metadata_update.cu``), the combining freq add
and last_ts max at one clock, into fresh tensors.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are
``kernels/ref.py::hit_metadata_update_ref_`` and ``metadata_update_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime


def hit_metadata_update_(freq, last_ts, ext, hit_slots, hit_ts, emit_slots,
                         emit_deltas) -> None:
    """Update ``freq``, ``last_ts`` and ``ext`` in place at the hit and
    flush slots (the ext update reads their step-entry values)."""
    C = freq.shape[0]
    dev = freq.device
    ts_eff = torch.empty(C, dtype=torch.int32, device=dev)
    claim = torch.empty(C, dtype=torch.int32, device=dev)
    freq0 = torch.empty(hit_slots.shape[0], dtype=torch.int32, device=dev)
    err = runtime.lib().hit_metadata_update_launch(
        freq.data_ptr(), last_ts.data_ptr(), ext.data_ptr(),
        hit_slots.data_ptr(), hit_ts.data_ptr(), hit_slots.shape[0],
        emit_slots.data_ptr(), emit_deltas.data_ptr(), emit_slots.shape[0],
        ts_eff.data_ptr(), claim.data_ptr(), freq0.data_ptr(),
        runtime.counter("hit_metadata_update", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "hit_metadata_update")


def metadata_update(freq, last_ts, slots, deltas, clock):
    """Returns updated (freq, last_ts), each a new tensor.  ``clock`` is
    a 0-d f32 tensor on the card or a float."""
    out = (freq.clone(), last_ts.clone())
    metadata_update_into(freq, last_ts, slots, deltas, clock, *out)
    return out


def metadata_update_into(freq, last_ts, slots, deltas, clock, freq_out,
                         last_out) -> None:
    """The kernel's passes alone: update ``*_out``, which hold a copy of
    the input columns, at the slots the batch names."""
    C = freq.shape[0]
    dev = freq.device
    claim = torch.empty(C, dtype=torch.int32, device=dev)
    count = torch.empty(C, dtype=torch.int32, device=dev)
    on_card = isinstance(clock, torch.Tensor)
    err = runtime.lib().metadata_update_launch(
        slots.data_ptr(), deltas.data_ptr(), slots.shape[0], C,
        freq.data_ptr(), last_ts.data_ptr(),
        clock.data_ptr() if on_card else None,
        0.0 if on_card else clock, claim.data_ptr(), count.data_ptr(),
        freq_out.data_ptr(), last_out.data_ptr(),
        runtime.counter("metadata_update", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "metadata_update")
