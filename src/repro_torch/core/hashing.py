"""Integer hashing for the sample-friendly hash table: the splitmix32
finalizer of ``repro/core/hashing.py`` on int64 tensors of u32 values."""

from __future__ import annotations

import torch

from repro_torch.core.u32 import M32, add32, mul32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit finalizer (splitmix64's mixer truncated to 32 bits)."""
    x = add32(x.to(torch.int64) & M32, 0x9E3779B9)
    x = mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_key(key: torch.Tensor) -> torch.Tensor:
    """Full 32-bit hash stored in the slot ``hash`` field."""
    return splitmix32(key)


def bucket_of(key_hash: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Bucket index (int64). n_buckets need not be a power of two."""
    return key_hash % n_buckets
