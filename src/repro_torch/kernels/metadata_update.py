"""Launchers of the metadata-update CUDA kernels: ``hit_metadata_update_``
(``csrc/hit_metadata_update.cu``), last_ts / ext at hit slots and the
FC-cache freq FAA at flush slots, in place in the table's columns, and
``metadata_update`` (``csrc/metadata_update.cu``), the combining freq add
and last_ts max at one clock, into fresh tensors (the copy is in the
same launch) or in place.

Each takes CUDA tensors already checked by its wrapper in
``kernels/ops.py``; the plain versions are
``kernels/ref.py::hit_metadata_update_ref_`` and ``metadata_update_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime

# Table slots that one CTA of csrc/metadata_update.cu owns (its TILE):
# the tests and chip_smoke.py place entries in one tile and on the edges
# of tiles with it.
TILE = 16384


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
    """Returns updated (freq, last_ts), each a new tensor, which the
    kernel writes whole (the copy of the input columns is in the launch).
    ``clock`` is a 0-d f32 tensor on the card or a float."""
    out = (torch.empty_like(freq), torch.empty_like(last_ts))
    metadata_update_into(freq, last_ts, slots, deltas, clock, *out)
    return out


def metadata_update_into(freq, last_ts, slots, deltas, clock, freq_out,
                         last_out) -> None:
    """Write the updated columns into ``*_out``: either the inputs' own
    tensors (the update in place, no copy) or other tensors of their
    shape, which are written whole."""
    if slots.shape[0] == 0:   # no launch: the copy alone
        for src, dst in ((freq, freq_out), (last_ts, last_out)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return
    dev = freq.device
    on_card = isinstance(clock, torch.Tensor)
    err = runtime.lib().metadata_update_launch(
        slots.data_ptr(), deltas.data_ptr(), slots.shape[0], freq.shape[0],
        freq.data_ptr(), last_ts.data_ptr(),
        clock.data_ptr() if on_card else None,
        0.0 if on_card else clock, freq_out.data_ptr(), last_out.data_ptr(),
        runtime.counter("metadata_update", dev),
        torch.cuda.current_stream(dev).cuda_stream)
    runtime.check(err, "metadata_update")
