"""The port's threefry-2x32 generator against ``jax.random``.

``repro_torch.core.prng`` must give, bit for bit, the raw uint32 keys and
bits that jax computes (``jax_threefry_partitionable=True``): every
sample offset and expert choice of the cache step depends on them.
Integer outputs are compared exactly; the uniform floats are compared
by their bit patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = list(range(8))
FOLD_DATA = [0, 1, 2**31, 2**32 - 1]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [2**31, 2**32 + 5, 2**63 - 1, -5])
def test_prngkey(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert np.array_equal(_np(prng.PRNGKey(seed)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 5, 64])
def test_split(seed, n):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    got = prng.split(prng.PRNGKey(seed), n)
    assert got.shape == (n, 2)
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", FOLD_DATA)
def test_fold_in(seed, data):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.fold_in(key, np.uint32(data)))
    got = prng.fold_in(prng.PRNGKey(seed), torch.tensor(data))
    assert np.array_equal(_np(got), want)


def test_fold_in_batched_matches_vmap():
    """The cache step folds each lane's key with its request timestamp."""
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    data = np.random.default_rng(0).integers(0, 2**32, 16, dtype=np.uint64)
    data = data.astype(np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data)))
    got = prng.fold_in(torch.tensor(np.asarray(keys).astype(np.int64)),
                       torch.tensor(data.astype(np.int64)))
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(7))
    want_bits = np.asarray(jax.random.bits(key, (2,)))
    want = np.asarray(jax.random.uniform(key, (2,)))
    tkey = torch.tensor(np.asarray(key).astype(np.int64))
    assert np.array_equal(_np(prng.random_bits(tkey, 2)), want_bits)
    got = prng.uniform(tkey, 2).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_batched_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(11), 33)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys))
    got = prng.uniform(torch.tensor(np.asarray(keys).astype(np.int64)), 2)
    assert got.shape == (33, 2)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
