"""The port's float sums in XLA's CPU order, against the jnp expressions
they mirror, on the CPU.

XLA on the CPU adds f32 one element at a time: a scatter-add in request
order, ``sum`` and ``cumsum`` over the last axis in index order, and a
reduce over a major axis in fixed row ranges (``cache._xla_chunks``).
PyTorch's CPU scan adds in f64 and its sums are pairwise, so the port
adds explicitly.  These sums pick the eviction expert (the cdf), the
drain's dominant expert (the tenant mean) and the synced weights, so
each is held bit-equal here, on seeded f32 inputs at 1, 4, 31, 32, 33,
64 and 128 rows and E = 1 to 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as j_cache
from repro_torch.core import cache as t_cache
from repro_torch.elastic import resize as t_resize

ROWS = (1, 4, 31, 32, 33, 64, 128)
LANES = 3


def _f32(rng, shape):
    """Positive f32 values over six decades, so that the order of the
    adds shows in the last bits."""
    return (rng.random(shape, dtype=np.float32)
            * rng.choice(np.float32([1e-3, 1.0, 1e3]), shape))


def _seqsum_case(rng, R, E):
    # The per-lane penalty sum: a scatter-add of R rounds x LANES lanes
    # onto the lanes, in request (round-major) order.
    x = _f32(rng, (R, LANES, E))
    lane = np.tile(np.arange(LANES), R)
    want = jax.jit(lambda v, i: jnp.zeros((LANES, E), jnp.float32)
                   .at[i].add(v))(x.reshape(R * LANES, E), lane)
    return t_cache._seqsum(torch.from_numpy(x)), want


def _xla_sum0_case(rng, R, E):
    x = _f32(rng, (R, LANES, E))
    want = jax.jit(lambda v: jnp.sum(v, axis=0))(x)
    return t_cache._xla_sum0(torch.from_numpy(x)), want


def _expert_cdf_case(rng, R, E):
    w = _f32(rng, (R, E))
    want = jax.jit(lambda v: jnp.cumsum(
        v / jnp.maximum(jnp.sum(v, axis=-1, keepdims=True), 1e-30),
        axis=-1))(w)
    return t_cache._expert_cdf(torch.from_numpy(w)), want


def _apply_penalties_case(rng, R, E):
    # No penalty, so exp(-lam * 0) = 1 exactly on both sides and the
    # normalising sum alone is compared (the exp of a penalty rounds
    # apart in the last place; the cache tests bound that).
    w = _f32(rng, (R, E))
    pen = np.zeros((R, E), np.float32)
    want = jax.jit(j_cache.apply_penalties)(w, pen, np.float32(0.1))
    return t_cache.apply_penalties(torch.from_numpy(w), torch.from_numpy(pen),
                                   0.1), want


def _tenant_mean_case(rng, R, E):
    # The drain's dominant-expert vote over R tenant rows of [T, E].
    w = _f32(rng, (R, E))
    want = jax.jit(lambda v: v.mean(axis=0))(w)
    return t_resize._tenant_mean(torch.from_numpy(w)), want


CASES = {"seqsum": _seqsum_case, "xla_sum0": _xla_sum0_case,
         "expert_cdf": _expert_cdf_case,
         "apply_penalties": _apply_penalties_case,
         "tenant_mean": _tenant_mean_case}


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("op", list(CASES))
def test_sums_follow_xla_order_bit_for_bit(op, rows):
    rng = np.random.default_rng(1000 * rows + len(op))
    for E in range(1, 9):
        for trial in range(6):
            got, want = CASES[op](rng, rows, E)
            got, want = got.numpy(), np.asarray(want)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
                f"{op} at {rows} rows, E = {E}, trial {trial}: "
                f"{np.count_nonzero(got != want)} of {got.size} differ")


def test_xla_chunks_cover_the_rows_in_order():
    for n in range(1, 300):
        spans = t_cache._xla_chunks(n)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a < b for a, b in spans)
        assert all(b == a2 for (_, b), (a2, _) in zip(spans, spans[1:]))
        assert all(b - a <= 32 for a, b in spans)
