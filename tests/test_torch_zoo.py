"""The six archs of the LM zoo that the dense slices left (olmoe-1b-7b,
moonshot-v1-16b-a3b, recurrentgemma-2b, xlstm-350m, internvl2-1b,
musicgen-large) against the JAX package, each at its ``smoke_config``,
and recurrentgemma-2b at 5 layers (one period of 3 and 2 remainder
blocks; ``smoke_config`` gives 3 layers and no remainder).

Params are the JAX package's ``init_params`` carried across with
``params_from_numpy``; tokens, labels and the stub frontends'
embeddings are made with numpy from a seed.  Each case's JAX outputs
are computed once (a module-scoped fixture, every JAX function jitted).
Tolerances:

* Init: the tree, shapes and dtypes equal; the scheme's zeros (every
  ``b_*``, ``b_f`` included) and ``lam``'s linspace equal in bf16;
  ``param_count`` and ``active_param_count`` equal (the full configs'
  in ``tests/test_torch_models.py``).
* Prefill, f32 hidden states: rtol = atol = 1e-4, the port's
  whole-forward tolerance (matmuls summed in another order).
* Training, f32: the loss within 1e-5 relative, its gradients
  (``torch.autograd`` against ``jax.value_and_grad``) within rtol = atol
  = 1e-4; the four ``remat`` modes bit-equal to ``"none"``.
* Decode, step by step against the JAX package's decode blocks from a
  fresh cache: f32 logits within 1e-4 and greedy tokens equal, the
  caches after the steps within 1e-4 (f32 states) and one bf16 rounding
  (bf16 ones).  xlstm decodes in bf16 (JAX's xLSTM decode runs in bf16
  only): each step's logits, and each cache leaf after the steps, within
  a relative L2 of twice the bf16 noise, which is the largest distance
  of JAX's own bf16 decode logits from its bf16 prefill's at the same
  positions (2-5% here: bf16 products summed in another order, over 8
  layers); tokens equal where JAX's top-2 margin exceeds 1e-2, as JAX's
  ``test_decode_matches_teacher_forcing`` holds its own.
* ``DecodeEngine`` on recurrentgemma: every request's tokens equal the
  JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models.model import active_param_count as j_active_param_count
from repro.models.model import forward as j_forward
from repro.models.model import param_count as j_param_count
from repro.serve import decode as jdecode
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (active_param_count, forward, init_params,
                                param_count, params_from_numpy,
                                params_to_numpy)
from repro_torch.serve import DecodeEngine, init_cache, reset_lane
from repro_torch.serve.decode import decode_logits
from repro_torch.train.optimizer import tree_leaves

NEW = ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "recurrentgemma-2b",
       "xlstm-350m", "internvl2-1b", "musicgen-large")
# (arch, n_layers): None keeps smoke_config's.
CASES = [(a, None) for a in NEW] + [("recurrentgemma-2b", 5)]
IDS = [a if n is None else f"{a}-{n}-layers" for a, n in CASES]
B, T = 2, 40            # T above the smoke window of 32
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=None):
    jcfg = j_smoke_config(j_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _rel(got, want) -> float:
    d = _np(got) - _np(want)
    return float(np.linalg.norm(d) / np.linalg.norm(_np(want)))


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, T + 1))
    inp = {"labels": toks[:, 1:]}
    if cfg.uses_tokens:
        inp["tokens"] = toks[:, :-1]
    else:
        inp["embeds"] = rng.standard_normal((B, T, cfg.d_model)
                                            ).astype(np.float32)
    steps = (rng.integers(1, cfg.vocab_size, (STEPS, B, 1)) if cfg.uses_tokens
             else rng.standard_normal((STEPS, B, 1, cfg.d_model)
                                      ).astype(np.float32))
    return inp, steps


def _jax_step(jcfg):
    """The JAX package's ``serve_step`` up to its f32 logits (its blocks,
    its scan over periods, then the remainder blocks), jitted."""
    def step(jp, cache, inp):
        if inp.ndim == 2:
            x = JL.embed(inp, jp["embed"], jcfg.embed_scale)
        else:
            x = inp.astype(jp["embed"].dtype)
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
        out = {"pos": pos + 1, "period": period}
        if jcfg.remainder:
            out["rem"] = {}
            for j, kind in enumerate(jcfg.remainder):
                key = f"{j}_{kind}"
                x, out["rem"][key] = jdecode._decode_block(
                    x, jp["rem"][key], jcfg, kind, cache["rem"][key], pos)
        x = JL.rms_norm(x, jp["final_norm"])
        table = jp["embed"] if jcfg.tie_embeddings else jp["unembed"]
        return jnp.einsum("btd,vd->btv", x, table).astype(jnp.float32), out
    return jax.jit(step)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """Everything the JAX package computes for one case, once."""
    arch, n_layers = request.param
    jcfg, cfg = _cfgs(arch, n_layers)
    inp, steps = _inputs(cfg, len(arch) + (n_layers or 0))
    dec_dt = jnp.bfloat16 if arch == "xlstm-350m" else jnp.float32
    # JAX's init draws every leaf in f32 and casts it, so its bf16 tree
    # is its f32 tree cast to bf16.
    f32 = j_init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    trees = {dt: jax.tree.map(lambda a: np.asarray(a.astype(dt)), f32)
             for dt in (jnp.float32, jnp.bfloat16)}
    jp = jax.tree.map(jnp.asarray, trees[jnp.float32])
    x_kw = ({"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
            if cfg.uses_tokens else {"embeds": jnp.asarray(inp["embeds"])})
    table = "embed" if jcfg.tie_embeddings else "unembed"

    def loss_fn(p):
        # ``forward`` with labels is the hidden states' cross entropy.
        h = j_forward(p, jcfg, **x_kw)
        return JL.logits_and_xent(h, p[table], jnp.asarray(
            inp["labels"], jnp.int32)), h

    (loss, hidden), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    hidden = np.asarray(hidden)

    jpd = jax.tree.map(jnp.asarray, trees[dec_dt])
    cache = jdecode.init_cache(jcfg, B, 16)
    jstep = _jax_step(jcfg)
    logits, tokens = [], []
    for s in range(STEPS):
        a = (jnp.asarray(steps[s], jnp.int32) if cfg.uses_tokens
             else jnp.asarray(steps[s]))
        lg, cache = jstep(jpd, cache, a)
        logits.append(np.asarray(lg))
        # make_serve_step's greedy token (its engine runs in
        # test_engine_on_recurrentgemma_matches_jax).
        tokens.append(np.asarray(lg)[:, -1, :cfg.vocab_size].argmax(-1))
    noise = None
    if dec_dt == jnp.bfloat16:
        # The bf16 noise: JAX's decode logits against its prefill's.
        h = jax.jit(lambda p, t: j_forward(p, jcfg, tokens=t))(
            jpd, jnp.asarray(steps[:, :, 0].T, jnp.int32))
        table = jpd["embed"] if jcfg.tie_embeddings else jpd["unembed"]
        pre = np.asarray(jnp.einsum("btd,vd->btv", h.astype(jnp.float32),
                                    table.astype(jnp.float32)))
        noise = max(_rel(logits[s][:, 0], pre[:, s]) for s in range(STEPS))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, inp=inp, steps=steps,
                trees=trees, dec_dt=dec_dt, hidden=hidden, loss=float(loss),
                noise=noise,
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                logits=logits, tokens=tokens,
                cache=jax.tree.map(np.asarray, cache))


def _x_kw(case):
    inp = case["inp"]
    if case["cfg"].uses_tokens:
        return {"tokens": torch.from_numpy(inp["tokens"])}
    return {"embeds": torch.from_numpy(inp["embeds"])}


# ---------------------------------------------------------------------------
# Configs, init and counts.
# ---------------------------------------------------------------------------

def test_init_has_the_jax_tree_scheme_and_counts(case):
    arch, jcfg, cfg = case["arch"], case["jcfg"], case["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = case["trees"][jnp.bfloat16]
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    got = params_to_numpy(params)
    assert (jax.tree.map(lambda a: (a.shape, a.dtype), got)
            == jax.tree.map(lambda a: (a.shape, a.dtype), tree))
    assert ("rem" in params) == bool(cfg.remainder)
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        name = path[-1].key
        b = got
        for p in path:
            b = b[p.key]
        if name.startswith(("norm", "b_", "lam")) or name == "final_norm":
            # Zeros (b_f too: JAX's ``b_f = 3.0`` branch is never
            # reached) and lam's linspace, bit for bit in bf16.
            np.testing.assert_array_equal(b.view(np.uint16),
                                          a.view(np.uint16), err_msg=name)
    blocks = [b for part in ("period", "rem") for b in params.get(part,
                                                                   {}).values()]
    assert any("lam" in b for b in blocks) == (arch == "recurrentgemma-2b")
    for b in blocks:
        if "b_f" in b:
            assert not b["b_f"].any()
    assert param_count(cfg) == j_param_count(jcfg)
    assert active_param_count(cfg) == j_active_param_count(jcfg)


# ---------------------------------------------------------------------------
# Prefill and training.
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(case):
    cfg = case["cfg"]
    params = params_from_numpy(case["trees"][jnp.float32], "cpu")
    got = forward(params, cfg, **_x_kw(case))
    assert got.shape == (B, T, cfg.d_model) and got.dtype == torch.float32
    _close(got, case["hidden"], 1e-4)


def _loss_and_grads(case, remat="none"):
    params = params_from_numpy(case["trees"][jnp.float32], "cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = forward(params, case["cfg"], labels=torch.from_numpy(
        case["inp"]["labels"]), remat=remat, **_x_kw(case))
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True)


def test_loss_and_gradients_match_jax(case):
    loss, grads = _loss_and_grads(case)
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=1e-5,
                               atol=0)
    assert len(grads) == len(case["grads"])
    for i, (g, w) in enumerate(zip(grads, case["grads"])):
        _close(g, w, 1e-4, f"gradient leaf {i}")


@pytest.mark.parametrize("remat", ["full", "dots", "save_outs"])
def test_remat_modes_are_bit_equal_to_none(case, remat):
    loss0, grads0 = _loss_and_grads(case)
    loss, grads = _loss_and_grads(case, remat)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def _port_decode(case):
    cfg = case["cfg"]
    td = torch.bfloat16 if case["dec_dt"] == jnp.bfloat16 else torch.float32
    params = params_from_numpy(case["trees"][case["dec_dt"]], "cpu")
    assert params["embed"].dtype == td
    cache = init_cache(cfg, B, 16, "cpu")
    key = "tokens" if cfg.uses_tokens else "embeds"
    logits = [decode_logits(params, cfg, cache, **{key: torch.from_numpy(a)})
              for a in case["steps"]]
    return logits, cache


def test_decode_matches_jax_step_by_step(case):
    logits, cache = _port_decode(case)
    cfg, noise = case["cfg"], case["noise"]
    for s, (got, want, jt) in enumerate(zip(logits, case["logits"],
                                            case["tokens"])):
        want_v = want[:, -1, :cfg.vocab_size]
        tok = got[:, -1, :cfg.vocab_size].argmax(-1).numpy()
        if noise is None:
            _close(got, want, 1e-4, f"step {s}")
            np.testing.assert_array_equal(tok, jt, f"step {s}")
            continue
        assert _rel(got, want) <= 2 * noise, (s, _rel(got, want), noise)
        top2 = np.sort(want_v, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-2
        np.testing.assert_array_equal(tok[clear], jt[clear], f"step {s}")
    np.testing.assert_array_equal(cache["pos"].numpy(), case["cache"]["pos"])
    want_c = case["cache"]
    for part in ("period", "rem"):
        assert set(cache.get(part, {})) == set(want_c.get(part, {}))
        for key, caches in cache.get(part, {}).items():
            for n, t in caches.items():
                w = want_c[part][key][n]
                bf16 = w.dtype == ml_dtypes.bfloat16
                assert t.dtype == (torch.bfloat16 if bf16
                                   else torch.float32), (key, n)
                what = f"{part}.{key}.{n}"
                if noise is not None:
                    assert _rel(t, w) <= 2 * noise, (what, _rel(t, w))
                elif bf16:      # one bf16 rounding apart
                    np.testing.assert_allclose(_np(t), _np(w), atol=2 ** -6,
                                               rtol=2 ** -7, err_msg=what)
                else:
                    _close(t, w, 1e-4, what)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_decode_with_f32_caches_equals_the_prefill(arch):
    """The recurrences' decode steps against their scans: f32 params and
    every cache leaf in f32, 40 tokens decoded one by one (past the smoke
    window of 32) against one prefill forward, within 1e-5.  With the
    JAX package's bf16 caches (the conv tail, the ring, the sLSTM h) the
    two differ by the caches' rounding; ``chip_smoke.py`` phase 16 makes
    both checks at full width."""
    _, cfg = _cfgs(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        1, cfg.vocab_size, (2, T)))
    cache = init_cache(cfg, 2, T, "cpu")
    cache = {k: v if k == "pos" else {
        key: {n: t.float() for n, t in c.items()} for key, c in v.items()}
        for k, v in cache.items()}
    dec = torch.cat([decode_logits(params, cfg, cache, tokens=toks[:, i:i + 1])
                     for i in range(T)], dim=1)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    pre = forward(params, cfg, tokens=toks) @ table.T
    _close(dec, pre, 1e-5)


def test_reset_lane_refills_the_slstm_stabiliser():
    jcfg, cfg = _cfgs("xlstm-350m")
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg,
                                                  jnp.bfloat16))
    params = params_from_numpy(tree, "cpu")
    cache = init_cache(cfg, 3, 8, "cpu")
    toks = torch.tensor([[5], [6], [7]])
    for _ in range(3):
        decode_logits(params, cfg, cache, tokens=toks)
    m = cache["period"]["3_slstm"]["m"]
    assert (m[:, 1] > -1e29).all()
    before = {k: {n: t.clone() for n, t in c.items()}
              for k, c in cache["period"].items()}
    want = jdecode.reset_lane(jcfg, jax.tree.map(
        lambda t: jnp.asarray(_np(t)), cache), 1)
    assert reset_lane(cfg, cache, 1) is cache
    assert cache["pos"].tolist() == [3, 0, 3]
    for key, caches in cache["period"].items():
        for n, t in caches.items():
            np.testing.assert_array_equal(_np(t), _np(want["period"][key][n]))
            fill = -1e30 if n == "m" else 0
            assert (t[:, 1].float() == fill).all(), (key, n)
            assert torch.equal(t[:, [0, 2]], before[key][n][:, [0, 2]])


def test_xlstm_decode_refuses_f32_params_as_jax_does():
    jcfg, cfg = _cfgs("xlstm-350m")
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    toks = np.ones((2, 1), np.int32)
    with pytest.raises(TypeError, match="carry"):
        jdecode.make_serve_step(jcfg)(jax.tree.map(jnp.asarray, tree),
                                      jdecode.init_cache(jcfg, 2, 8),
                                      tokens=jnp.asarray(toks))
    params = params_from_numpy(tree, "cpu")
    cache = init_cache(cfg, 2, 8, "cpu")
    before = {k: {n: t.clone() for n, t in c.items()}
              for k, c in cache["period"].items()}
    with pytest.raises(TypeError, match="carry"):
        decode_logits(params, cfg, cache, tokens=torch.from_numpy(toks))
    # Refused before any cache was written.
    assert not cache["pos"].any()
    for key, caches in cache["period"].items():
        for n, t in caches.items():
            assert torch.equal(t, before[key][n])


def test_engine_on_recurrentgemma_matches_jax():
    """Continuous batching on a recurrent arch: requests take over lanes
    whose RG-LRU state and attn_local ring ``reset_lane`` must clear."""
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    rng = np.random.default_rng(19)
    shared = rng.integers(1, cfg.vocab_size, 32).astype(np.uint32)
    prompts = [shared,
               rng.integers(1, cfg.vocab_size, 12).astype(np.uint32),
               np.concatenate([shared, rng.integers(1, cfg.vocab_size, 8)
                               ]).astype(np.uint32),
               rng.integers(1, cfg.vocab_size, 20).astype(np.uint32)]
    kw = dict(lanes=2, max_len=64, page_size=16, pool_pages=4)
    engines = (JDecodeEngine(jcfg, jax.tree.map(jnp.asarray, tree), **kw),
               DecodeEngine(cfg, params_from_numpy(tree, "cpu"), **kw))
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(p, 5 + i, rid=i)
    jdone, tdone = ({r.rid: r for r in e.run()} for e in engines)
    assert sorted(tdone) == sorted(jdone) == list(range(len(prompts)))
    for rid in jdone:
        assert tdone[rid].out == jdone[rid].out, rid
        assert tdone[rid].pages_skipped == jdone[rid].pages_skipped, rid
    assert engines[1].steps == engines[0].steps


@pytest.mark.parametrize("arch", NEW)
def test_launchers_run_every_new_arch_on_the_cpu(arch, capsys, tmp_path):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                    "--batch", "2", "--prompt-len", "8", "--gen", "2",
                    "--pool-pages", "4"])
    assert f"[cpu] {arch}-smoke: served 2 requests: 4 new tokens" in (
        capsys.readouterr().out)
    loop = train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                           "--batch", "2", "--seq", "16", "--ckpt",
                           str(tmp_path)])
    assert len(loop.losses) == 2 and all(np.isfinite(loop.losses))
