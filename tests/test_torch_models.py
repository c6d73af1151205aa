"""The port's LM layers, attention and prefill forward against the JAX
package's, on the CPU.

Inputs and weights are made with numpy from a seed (or by the JAX
package's ``init_params`` and carried across with
``params_from_numpy``) and go through both packages.  Tolerances:
f32 elementwise layers within 1e-6 (the same f32 operations), rope
within 2e-5 (XLA and PyTorch round sin and cos of angles up to 4096
rad apart) and bf16 rms_norm within one bf16 rounding; attention
within 2e-5 in f32 and 2e-2 in bf16, as ``tests/test_kernels.py`` holds
the Pallas flash kernel; whole forwards in f32 within rtol = atol =
1e-4 (matmuls summed in another order, over every layer).

The CUDA flash kernel builds and runs only on the card:
``tests/test_torch_cuda.py`` holds it against ``flash_attention_ref``
there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as jatt
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models.model import forward as j_forward
from repro.models.model import active_param_count as j_active_param_count
from repro.models.model import param_count as j_param_count
from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tatt
from repro_torch.models import layers as TL
from repro_torch.models.model import (active_param_count, forward,
                                      init_params, param_count,
                                      params_from_numpy, params_to_numpy)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype="f32"):
    """One numpy f32 array as a JAX array and a torch tensor of dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(rng, b, t, h, d):
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

_FLASH_CASES = [
    (2, 256, 4, 64, 128, 128, "f32", 1),
    (1, 512, 2, 128, 128, 64, "f32", 1),
    (2, 128, 3, 32, 64, 128, "f32", 1),
    (2, 256, 2, 64, 128, 128, "bf16", 1),
    # Head dim 256 (gemma-2b's): heads of their own, GQA, and MQA in bf16.
    (1, 256, 2, 256, 128, 128, "f32", 1),
    (2, 128, 4, 256, 64, 128, "f32", 2),
    (1, 256, 4, 256, 128, 64, "bf16", 4),
]


@pytest.mark.parametrize(
    "b,t,h,d,bq,bk,dtype,n_rep", _FLASH_CASES,
    ids=["-".join(map(str, c[:7])) + (f"-gqa{c[7]}" if c[7] > 1 else "")
         for c in _FLASH_CASES])
def test_flash_attention_ref_matches_the_pallas_kernel(b, t, h, d, bq, bk,
                                                       dtype, n_rep):
    """The Pallas kernel takes GQA pre-expanded (``repeat_kv`` in JAX);
    the port takes ``repeat_kv``'s view of the H / n_rep kv heads."""
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.standard_normal((b, t, hh, d)).astype(np.float32)
               for hh in (h, h // n_rep, h // n_rep))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    if n_rep > 1:
        jk, jv = jatt.repeat_kv(jk, n_rep), jatt.repeat_kv(jv, n_rep)
        tk, tv = tatt.repeat_kv(tk, n_rep), tatt.repeat_kv(tv, n_rep)
    want = j_flash(jq, jk, jv, blk_q=bq, blk_k=bk, interpret=True)
    got = ops.flash_attention_op(tq, tk, tv)     # CPU: the plain version
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, t, h, d)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("t", [1, 37, 100])
def test_flash_attention_ref_at_a_ragged_t_and_in_row_blocks(t):
    """T that no tile divides (the Pallas kernel asserts divisibility,
    so JAX's full_attention is the reference), and the plain version's
    row blocks (a score budget of a few rows) against one block."""
    rng = np.random.default_rng(t)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(rng, 2, t, 3, 32))
    want = _np(jatt.full_attention(jq, jk, jv))
    np.testing.assert_allclose(_np(ref.flash_attention_ref(tq, tk, tv)), want,
                               atol=2e-5, rtol=2e-5)
    blocked = ref.flash_attention_ref(tq, tk, tv,
                                      max_score_bytes=4 * 2 * 3 * t * 7)
    np.testing.assert_allclose(_np(blocked), want, atol=2e-5, rtol=2e-5)


def test_repeat_kv_is_a_view_of_the_jax_expansion():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    jk, tk = _both(a)
    view = tatt.repeat_kv(tk, 4)
    assert view.data_ptr() == tk.data_ptr() and view.stride(3) == 0
    np.testing.assert_array_equal(_np(ref.gqa_heads(view)),
                                  _np(jatt.repeat_kv(jk, 4)))


def test_flash_attention_op_takes_the_gqa_view():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    got = ops.flash_attention_op(q, tatt.repeat_kv(k, 3), tatt.repeat_kv(v, 3))
    want = ops.flash_attention_op(q, k.repeat_interleave(3, dim=2),
                                  v.repeat_interleave(3, dim=2))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "heads", "rank"])
def test_flash_attention_op_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = {"shape": torch.zeros(1, 9, 4, 32),
         "dtype": torch.zeros(1, 8, 4, 32, dtype=torch.float64),
         "heads": torch.zeros(1, 8, 3, 32),
         "rank": torch.zeros(8, 4, 32)}[bad]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention_op(q, k, k)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("q_offset", [0, 16])
def test_full_and_chunked_attention_match_jax(window, q_offset):
    rng = np.random.default_rng(window + q_offset)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(window=window, q_offset=q_offset)
    np.testing.assert_allclose(
        _np(tatt.full_attention(tq, tk, tv, **kw)),
        _np(jatt.full_attention(jq, jk, jv, **kw)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(tatt.chunked_attention(tq, tk, tv, chunk=16, **kw)),
        _np(jatt.chunked_attention(jq, jk, jv, chunk=16, **kw)),
        atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

def test_rms_norm_rope_and_embed_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    (jx, tx), (js, ts) = _both(x), _both(scale)
    np.testing.assert_allclose(_np(TL.rms_norm(tx, ts)),
                               _np(JL.rms_norm(jx, js)), atol=1e-6, rtol=1e-6)
    # bf16 activations keep their dtype; the inner math is f32 in both.
    got = TL.rms_norm(*(_both(a, "bf16")[1] for a in (x, scale)))
    want = JL.rms_norm(*(_both(a, "bf16")[0] for a in (x, scale)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=1e-2)

    h = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7))
    np.testing.assert_allclose(
        _np(TL.rope(torch.from_numpy(h), torch.from_numpy(pos), 10000.0)),
        _np(JL.rope(jnp.asarray(h), jnp.asarray(pos), 10000.0)),
        atol=2e-5, rtol=1e-5)

    table = rng.standard_normal((50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    for scaled in (False, True):
        np.testing.assert_array_equal(
            _np(TL.embed(torch.from_numpy(toks), torch.from_numpy(table),
                         scaled)),
            _np(JL.embed(jnp.asarray(toks), jnp.asarray(table), scaled)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_gated_mlp_matches_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((32, 48), (32, 48), (48, 32))]
    got = TL.gated_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws), kind)
    want = JL.gated_mlp(jnp.asarray(x), *map(jnp.asarray, ws), kind)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Configs, params and the prefill forward.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    for port, jax_cfg in ((get_arch(arch), j_get_arch(arch)),
                          (smoke_config(get_arch(arch)),
                           j_smoke_config(j_get_arch(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert param_count(get_arch(arch)) == j_param_count(j_get_arch(arch))
    assert (active_param_count(get_arch(arch))
            == j_active_param_count(j_get_arch(arch)))


def _jax_params(cfg_name: str, dtype=jnp.float32, seed: int = 0):
    jcfg = j_smoke_config(j_get_arch(cfg_name))
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg, dtype)
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def test_params_round_trip_through_numpy():
    _, _, tree = _jax_params("yi-9b", jnp.bfloat16)
    params = params_from_numpy(tree, "cpu")
    assert params["period"]["0_attn"]["wq"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_init_params_has_the_jax_tree_and_scheme():
    cfg = smoke_config(get_arch("yi-9b"))
    _, _, tree = _jax_params("yi-9b")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          params_to_numpy(params))
    assert shapes == jax.tree.map(lambda a: (a.shape, "bfloat16"), tree)
    blk = params["period"]["0_attn"]
    assert not blk["norm1"].any() and not params["final_norm"].any()
    std = blk["w_down"].float().std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(params["embed"].float().std().item() - 0.02) < 0.002


@pytest.mark.parametrize("arch", ["smollm-135m", "yi-9b"])
def test_forward_matches_jax(arch):
    jcfg, jp, tree = _jax_params(arch)
    cfg = smoke_config(get_arch(arch))
    params = params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24))
    want = np.asarray(j_forward(jp, jcfg, tokens=jnp.asarray(toks)))
    got = forward(params, cfg, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_at_head_dim_256_matches_jax():
    """gemma-2b's smoke config at gemma-2b's own head dim of 256 (the
    smoke configs cut it to 16): the head dim the card's flash kernel
    took last.  On the CPU the port's attention is the plain version."""
    jcfg = dataclasses.replace(j_smoke_config(j_get_arch("gemma-2b")),
                               head_dim=256)
    cfg = dataclasses.replace(smoke_config(get_arch("gemma-2b")),
                              head_dim=256)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert params["period"]["0_attn"]["wq"].shape[-2:] == (
        cfg.d_model, cfg.n_heads * 256)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    want = np.asarray(j_forward(jp, jcfg, tokens=jnp.asarray(toks)))
    got = forward(params, cfg, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_refuses_training_arguments():
    """``labels`` and the JAX package's four ``remat`` modes run since
    the training path was ported (``tests/test_torch_train.py``); a
    ``remat`` mode the JAX package lacks is refused."""
    cfg = smoke_config(get_arch("smollm-135m"))
    with pytest.raises(ValueError, match="remat"):
        forward({}, cfg, tokens=torch.zeros(1, 2, dtype=torch.int64),
                labels=torch.zeros(1, 2, dtype=torch.int64),
                remat="offload")
