"""The port's serving path against the JAX package's, on the CPU: the
decode step, the Ditto page cache and the continuous-batching engine.

Weights are the JAX package's ``init_params`` in f32, carried across
with ``params_from_numpy``; prompts are made with numpy from a seed.
The decode step's logits agree within 1e-4 in f32 (matmuls summed in
another order; the KV cache is bf16 in both packages) and its greedy
tokens are equal.  The page cache's integer results (hits per prompt,
evictions, regrets, physical pages) are equal, and its expert weights
equal within 4 ulp (f32 exp and pow in the regret update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.serve import decode as jdecode
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.page_cache import DittoPageCache as JDittoPageCache
from repro.serve.page_cache import prefix_page_keys as j_prefix_page_keys
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import params_from_numpy
from repro_torch.serve import (DecodeEngine, DittoPageCache, init_cache,
                               make_serve_step, reset_lane)
from repro_torch.serve.decode import decode_logits
from repro_torch.serve.page_cache import prefix_page_keys


@pytest.fixture(scope="module", params=["smollm-135m", "yi-9b"])
def model(request):
    jcfg = j_smoke_config(j_get_arch(request.param))
    jp = j_init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, smoke_config(get_arch(request.param)), params


def _jax_step_logits(jp, jcfg, cache, toks):
    """The JAX package's ``serve_step`` up to its logits (the same
    blocks and scan, returning the f32 logits and the new cache)."""
    x = JL.embed(toks, jp["embed"], jcfg.embed_scale)
    pos = cache["pos"]

    def body(xc, xs):
        bps, bcs = xs
        new = {}
        for j, kind in enumerate(jcfg.block_pattern):
            key = f"{j}_{kind}"
            xc, new[key] = jdecode._decode_block(xc, bps[key], jcfg, kind,
                                                 bcs[key], pos)
        return xc, new

    x, period = jax.lax.scan(body, x, (jp["period"], cache["period"]))
    x = JL.rms_norm(x, jp["final_norm"])
    table = jp["embed"] if jcfg.tie_embeddings else jp["unembed"]
    logits = jnp.einsum("btd,vd->btv", x, table).astype(jnp.float32)
    return logits, {"pos": pos + 1, "period": period}


def test_serve_step_matches_jax_over_8_steps(model):
    jcfg, jp, cfg, params = model
    B, S = 3, 16
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (8, B, 1))
    j_step = jax.jit(jdecode.make_serve_step(jcfg))
    jc_real = jc = jdecode.init_cache(jcfg, B, S)
    tc = init_cache(cfg, B, S, "cpu")
    tc_real = init_cache(cfg, B, S, "cpu")
    step = make_serve_step(cfg)
    for i in range(8):
        jt = jnp.asarray(toks[i], jnp.int32)
        want, jc = _jax_step_logits(jp, jcfg, jc, jt)
        j_next, jc_real = j_step(jp, jc_real, tokens=jt)
        got = decode_logits(params, cfg, tc, tokens=torch.from_numpy(toks[i]))
        t_next, tc_real = step(params, tc_real, tokens=torch.from_numpy(toks[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(j_next), np.asarray(want)[:, -1, :cfg.vocab_size]
            .argmax(-1))
        np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
    np.testing.assert_array_equal(tc_real["pos"].numpy(),
                                  np.asarray(jc_real["pos"]))
    for n in ("k", "v"):
        np.testing.assert_allclose(
            tc_real["period"]["0_attn"][n].float().numpy(),
            np.asarray(jc_real["period"]["0_attn"][n].astype(jnp.float32)),
            atol=2 ** -6, rtol=2 ** -7)   # one bf16 rounding apart at most


def test_reset_lane_zeroes_only_that_lane(model):
    _, _, cfg, params = model
    cache = init_cache(cfg, 3, 8, "cpu")
    toks = torch.tensor([[5], [6], [7]])
    step = make_serve_step(cfg)
    for _ in range(3):
        step(params, cache, tokens=toks)
    before = {n: t.clone() for n, t in cache["period"]["0_attn"].items()}
    assert reset_lane(cfg, cache, 1) is cache
    assert cache["pos"].tolist() == [3, 0, 3]
    for n, t in cache["period"]["0_attn"].items():
        assert not t[:, 1].any()
        assert torch.equal(t[:, [0, 2]], before[n][:, [0, 2]])


def test_prefix_page_keys_match_jax():
    rng = np.random.default_rng(6)
    for n in (0, 15, 16, 100):
        t = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(prefix_page_keys(t, 16),
                                      j_prefix_page_keys(t, 16))


def test_page_cache_matches_jax_under_eviction_pressure():
    """Hot shared prefixes and one-shot prompts through a 16-page pool:
    every decision of the Ditto core is the JAX package's."""
    rng = np.random.default_rng(7)
    hot = [rng.integers(1, 1000, 64).astype(np.uint32) for _ in range(2)]
    prompts = []
    for i in range(14):
        prompts.append(hot[i % 2])
        prompts.append(rng.integers(10_000 + i * 1000, 11_000 + i * 1000,
                                    48 + 16 * (i % 3)).astype(np.uint32))
    jpc = JDittoPageCache(n_pages=16, page_size=16)
    tpc = DittoPageCache(n_pages=16, page_size=16, device="cpu")
    for p in prompts:
        jk, jpages, jhit = jpc.lookup_or_allocate(p)
        tk, tpages, thit = tpc.lookup_or_allocate(p)
        assert thit == jhit
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tpages, jpages)
    assert int(tpc.stats.evictions) == int(jpc.stats.evictions) > 0
    assert tpc.regrets == jpc.regrets > 0
    assert tpc.hit_rate == jpc.hit_rate > 0
    assert int(tpc.state.n_cached) == int(jpc.state.n_cached)
    np.testing.assert_array_max_ulp(tpc.weights, jpc.weights, maxulp=4)


def test_engine_matches_jax_with_staggered_requests(model):
    jcfg, jp, cfg, params = model
    rng = np.random.default_rng(8)
    shared = rng.integers(1, cfg.vocab_size, 32).astype(np.uint32)
    prompts = [shared,
               rng.integers(1, cfg.vocab_size, 12).astype(np.uint32),
               np.concatenate([shared, rng.integers(1, cfg.vocab_size, 8)
                               ]).astype(np.uint32),
               shared]
    kw = dict(lanes=2, max_len=64, page_size=16, pool_pages=4)
    engines = (JDecodeEngine(jcfg, jp, **kw), DecodeEngine(cfg, params, **kw))
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(p, 5 + i, rid=i)
    (jdone, tdone) = ({r.rid: r for r in e.run()} for e in engines)
    assert sorted(tdone) == sorted(jdone) == list(range(len(prompts)))
    for rid in jdone:
        assert tdone[rid].out == jdone[rid].out, rid
        assert tdone[rid].pages_skipped == jdone[rid].pages_skipped, rid
    assert sum(r.pages_skipped for r in tdone.values()) >= 2
    assert engines[1].steps == engines[0].steps
    assert engines[1].prefix_hit_rate == engines[0].prefix_hit_rate


def test_engine_lanes_are_isolated(model):
    """Two staggered requests on shared lanes decode as each does alone
    (per-lane positions and the in-place lane reset)."""
    _, _, cfg, params = model
    rng = np.random.default_rng(9)
    p1, p2 = (rng.integers(1, cfg.vocab_size, n).astype(np.uint32)
              for n in (12, 20))

    def solo(p):
        eng = DecodeEngine(cfg, params, lanes=1, max_len=64)
        eng.submit(p, 6, rid=0)
        return eng.run()[0].out

    eng = DecodeEngine(cfg, params, lanes=2, max_len=64)
    eng.submit(p1, 6, rid=1)
    eng.submit(p2, 6, rid=2)
    done = {r.rid: r.out for r in eng.run()}
    assert done == {1: solo(p1), 2: solo(p2)}


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--requests", "4", "--batch", "2",
                    "--prompt-len", "32", "--gen", "2", "--pool-pages", "4"])
    out = capsys.readouterr().out
    assert "[cpu] smollm-135m-smoke: served 4 requests: 8 new tokens" in out
    assert "prefix cache: hit_rate=" in out
