"""Gradient compression for the data-parallel all-reduce: int8 block
quantization with error feedback, as in ``repro/train/grad_compress.py``.

int8 payloads with one f32 scale per ``BLOCK`` elements carry about 4x
fewer bytes than an f32 all-reduce; error feedback (each quantization's
residual is added back into the next step's gradient) keeps
convergence.  Bit-equal to the JAX package's functions as they run
(op by op, as its tests call them): the same f32 operations in the same
order (``torch.round`` and ``jnp.round`` both round half to even), each
division by a tensor on the data's device, since a CUDA division by a
host scalar multiplies by its reciprocal.  Under ``jit`` XLA compiles
the JAX functions otherwise (the division by 127 as a multiply by its
reciprocal, the error's multiply and subtract as one fma), which moves
the last bits of the scales and the error.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


class CompressState(NamedTuple):
    error: torch.Tensor  # f32[N] error-feedback residual


BLOCK = 1024


def init_compress(n: int, device=None) -> CompressState:
    return CompressState(torch.zeros((n,), dtype=F32, device=device))


def _quantize(g: torch.Tensor, st: CompressState, reduce_scale=None):
    """(g + error) in blocks -> (q int8 [nb, BLOCK], scale f32 [nb, 1],
    the dequantized [N], g + error).  ``reduce_scale`` replaces the
    per-block scale by a shared one (the all-reduce's MAX)."""
    n = g.shape[0]
    ge = g + st.error
    gb = F.pad(ge, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = gb.abs().amax(dim=1, keepdim=True) / torch.tensor(
        127.0, dtype=F32, device=g.device)
    scale = torch.clamp(scale, min=1e-12)
    if reduce_scale is not None:
        reduce_scale(scale)
    q = torch.clamp(torch.round(gb / scale), -127, 127).to(torch.int8)
    deq = (q.to(F32) * scale).reshape(-1)[:n]
    return q, scale, deq, ge


def compress(g: torch.Tensor, st: CompressState
             ) -> Tuple[torch.Tensor, torch.Tensor, CompressState]:
    """g: f32[N] -> (q int8[N padded to BLOCK], scales f32[N/BLOCK], new
    state)."""
    q, scale, deq, ge = _quantize(g, st)
    return q.reshape(-1), scale[:, 0], CompressState(ge - deq)


def decompress(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    return (q.reshape(-1, BLOCK).to(F32) * scales[:, None]).reshape(-1)[:n]


def compressed_allreduce(g: torch.Tensor, st: CompressState, group=None):
    """Quantize -> (sum across the group) -> dequantize with a shared
    per-block scale.  Returns (the mean gradient f32[N], new state).

    With ``group=None`` it is the quantize and dequantize round trip
    with error feedback.  With a ``torch.distributed`` process group
    (the JAX package's ``axis_name`` path): an all-reduce MAX of the
    per-block scales, so that every rank quantizes into the same grid,
    then a SUM of the int8 values as int32 (exact below ~2^24 ranks),
    divided by the world size."""
    n = g.shape[0]
    if group is None:
        q, scales, st = compress(g, st)
        return decompress(q, scales, n), st
    import torch.distributed as dist
    q, scale, deq, ge = _quantize(
        g, st, lambda s: dist.all_reduce(s, op=dist.ReduceOp.MAX,
                                         group=group))
    q32 = q.to(torch.int32)
    dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
    total = (q32.to(F32) * scale).reshape(-1)[:n]
    world = torch.tensor(float(dist.get_world_size(group)), dtype=F32,
                         device=g.device)
    return total / world, CompressState(ge - deq)
