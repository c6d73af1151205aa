"""Unsigned 32-bit arithmetic on int64 tensors.

PyTorch has no CPU add, shift, mod or compare for ``torch.uint32``, so
every u32 column of the cache is carried as ``int64`` holding a value in
[0, 2^32).  These helpers keep that invariant: each wrapping operation
masks its result back to 32 bits, and multiplication is split so that
no intermediate leaves the signed 64-bit range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def add32(a, b) -> torch.Tensor:
    return (a + b) & M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c in [0, 2^32):
    two 16-bit halves of c keep every partial product below 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))
