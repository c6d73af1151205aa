"""The ``OpStats`` counters' width against the JAX package, on the CPU.

The JAX package keeps its counters as i32 when x64 is off, and its byte
counters wrap past 2^31 on long sized traces; the port keeps them as
int64 (ROADMAP Queue 3, "Mirrored").  The rule: the port's op counters
equal JAX's exactly and its byte counters equal JAX's modulo 2^32, and
the port's stay non-negative and true.  Both caches start a short sized
trace with their byte counters 10,000 short of 2^31, so the run's bytes
carry JAX's past it.  The port's int64 tensors are read directly: the
usual ``_assert_tree`` comparison would flag the wrap, which is the
point.
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import types as j_types
from repro.core.execute import execute as j_execute
from repro.core.execute import make as j_make
from repro_torch.core import types as t_types
from repro_torch.core.execute import execute as t_execute
from repro_torch.core.execute import make as t_make
from repro_torch.workloads import gen as t_gen

C = 8
PRESET = 2**31 - 10_000
BYTES = ("rdma_read_bytes", "rdma_write_bytes", "hit_bytes", "miss_bytes")


def test_byte_counters_past_2_31_equal_jax_modulo_2_32():
    kw = dict(n_buckets=64, assoc=4, capacity=96, sync_period=4,
              experts=("lru", "lfu", "gdsf", "lrfu"), backend="reference")
    cfg_j, cfg_t = j_types.CacheConfig(**kw), t_types.CacheConfig(**kw)
    keys, sizes = t_gen.sized_zipfian(C * 150, 500, seed=6, max_blocks=8)
    keys, sizes = keys.reshape(-1, C), sizes.reshape(-1, C)

    jc = j_make(cfg_j, C, 0)
    jc = jc._replace(stats=jc.stats._replace(
        **{f: jnp.asarray(PRESET, getattr(jc.stats, f).dtype)
           for f in BYTES}))
    tc = t_make(cfg_t, C, 0, device="cpu")
    tc = tc._replace(stats=t_types.stats_from_numpy(jc.stats, "cpu"))
    assert all(int(getattr(tc.stats, f)) == PRESET for f in BYTES)

    jr = j_execute(jc, keys, plan=None, sizes=sizes)
    tr = t_execute(tc, keys, plan=None, sizes=sizes)
    fresh = t_execute(t_make(cfg_t, C, 0, device="cpu"), keys, plan=None,
                      sizes=sizes)
    assert np.array_equal(tr.hits, np.asarray(jr.hits))

    for f in t_types.OpStats._fields:
        got = getattr(tr.stats, f)
        want = int(np.asarray(getattr(jr.stats, f)))
        assert got.dtype == torch.int64 and got.shape == ()
        if f in BYTES:
            run = int(getattr(fresh.stats, f))
            assert run > 10_000, f          # the run crosses 2^31 in JAX
            assert want < 0, f               # JAX's i32 wrapped negative
            assert int(got) == PRESET + run >= 0, f
            assert (int(got) - want) % 2**32 == 0, f
        else:
            assert int(got) == want, f
    assert int(tr.stats.gets) > 0 and int(tr.stats.hits) > 0

    assert j_types.byte_hit_ratio(jr.stats) == 0.0
    hit_b, miss_b = int(tr.stats.hit_bytes), int(tr.stats.miss_bytes)
    got = t_types.byte_hit_ratio(tr.stats)
    assert got == hit_b / (hit_b + miss_b) and 0.0 < got < 1.0
