"""Threefry-2x32 counter-based PRNG on integer tensors.

Reproduces, bit for bit, what ``jax.random`` computes for raw uint32[2]
keys under ``jax_threefry_partitionable=True`` (the jax 0.9 default):

* ``PRNGKey(seed)``      -> [0, seed & 0xFFFFFFFF]
* ``split(key, n)``      -> threefry(key, (0, i)) for i < n, as [n, 2]
* ``fold_in(key, d)``    -> threefry(key, (0, d))
* ``uniform(key, (n,))`` -> bits_i = y0 ^ y1 of threefry(key, (0, i)),
  then the 23 high bits OR'd into 1.0f, minus 1.

The counter pair is (hi, lo) of the flat element index, as
``jax._src.prng.iota_2x32_shape`` builds it.  Keys are int64 tensors
holding u32 values (see ``core/u32.py``); every function broadcasts over
leading axes, which is what ``jax.vmap`` of the scalar versions does.
"""

from __future__ import annotations

import torch

from repro_torch.core.u32 import M32, add32, rotl32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block function (20 rounds), elementwise over
    broadcast int64 tensors of u32 values.  Returns (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = add32(x0, ks[0])
    x1 = add32(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add32(x0, x1)
            x1 = rotl32(x1, r) ^ x0
        x0 = add32(x0, ks[(i + 1) % 3])
        x1 = add32(add32(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """[0, seed mod 2^32]: jax with 64-bit types off (its default, which
    the JAX package keeps) narrows the seed to 32 bits first."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """[2] key -> [n, 2] subkeys."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[..., 2] keys, [...] u32 data -> [..., 2] keys."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & M32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] keys -> [..., n] u32 bits (as int64)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] keys -> f32[..., n] uniform in [0, 1), as
    ``jax.random.uniform(key, (n,))``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
