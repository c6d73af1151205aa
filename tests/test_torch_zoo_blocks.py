"""The port's zoo blocks (MoE, RG-LRU, mLSTM, sLSTM, layer_norm and the
sliding-window attention with its decode ring) against the JAX
package's, on the CPU.

Inputs and weights are made with numpy from a seed and go through both
packages, in f32 unless noted.  Tolerances:

* MoE routing (``topi``, ``pos``, ``keep``, ``idx_buf``): bit-equal,
  ties at the k-th choice included (a stable sort keeps XLA's
  lowest-index-first order); ``topv`` within 1e-6 (``exp`` and the sum
  round apart).  ``moe_block`` within 1e-5: products summed in another
  order.
* ``causal_conv1d`` in bf16: bit-equal (each of its W sums rounded to
  bf16 in both).
* ``rglru_scan`` and ``rglru_step``, the mLSTM and the sLSTM: within
  1e-5 (``exp``, ``log1p`` and ``sqrt`` of XLA and PyTorch differ in the
  last bits; the scans combine the same pairs in the same order).
* ``layer_norm``: 1e-6.  The windowed ``attention_block`` and the ring
  decode: 1e-5 (the ring's K/V are bf16 in both packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as jatt
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import xlstm as jxl
from repro.serve import decode as jdecode
from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import xlstm as txl
from repro_torch.serve import decode as tdecode


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _w(rng, *shape, scale=None):
    scale = shape[-2] ** -0.5 if scale is None else scale
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(tree, dtype="f32"):
    """A dict of numpy arrays as (JAX arrays, torch tensors)."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return ({k: jnp.asarray(v, jd) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(td) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------

def _jax_route(gate_logits, k, capacity_factor):
    """``repro/models/moe.py``'s routing lines (gates to idx_buf), as
    ``moe_block`` runs them."""
    n_tok, e = gate_logits.shape
    gates = jax.nn.softmax(gate_logits, axis=-1)
    topv, topi = jax.lax.top_k(gates, k)
    topv = topv / jnp.maximum(jnp.sum(topv, axis=-1, keepdims=True), 1e-9)
    cap = int(max(1, round(n_tok * k / e * capacity_factor)))
    eid = topi.reshape(-1)
    order = jnp.argsort(eid, stable=True)
    sorted_eid = eid[order]
    starts = jnp.searchsorted(sorted_eid, jnp.arange(e, dtype=eid.dtype))
    pos_sorted = (jnp.arange(n_tok * k, dtype=jnp.int32)
                  - starts[sorted_eid].astype(jnp.int32))
    pos = jnp.zeros_like(pos_sorted).at[order].set(pos_sorted)
    keep = pos < cap
    eid_s = jnp.where(keep, eid, e)
    idx_buf = jnp.full((e, cap), n_tok * k, jnp.int32)
    idx_buf = idx_buf.at[eid_s, jnp.where(keep, pos, 0)].set(
        jnp.arange(n_tok * k, dtype=jnp.int32), mode="drop")
    return topv, topi, pos, keep, idx_buf


def _logits(kind, rng, n, e):
    if kind == "f32":
        return rng.standard_normal((n, e)).astype(np.float32)
    if kind == "ties":
        # A handful of values: most rows tie at their k-th choice.
        return (rng.integers(0, 4, (n, e)) * 0.5).astype(np.float32)
    # bf16 products cast to f32, as moe_block's router makes them.
    x = jnp.asarray(rng.standard_normal((n, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, e)) * 0.05, jnp.bfloat16)
    return np.asarray((x @ w).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["f32", "ties", "bf16"])
@pytest.mark.parametrize("n,e,k,cf", [(64, 8, 2, 1.25), (256, 64, 8, 1.25),
                                      (96, 64, 6, 0.5), (3, 8, 2, 1.25)])
def test_moe_routing_is_bit_equal_to_jax(kind, n, e, k, cf):
    rng = np.random.default_rng(n + e + k)
    gl = _logits(kind, rng, n, e)
    jv, ji, jp, jk, jb = jax.jit(_jax_route, static_argnums=(1, 2))(
        jnp.asarray(gl), k, cf)
    r = tmoe.moe_route(torch.from_numpy(gl.copy()), k, cf)
    if kind == "ties":
        srt = np.sort(gl, axis=-1)[:, ::-1]
        assert (srt[:, k - 1] == srt[:, k]).mean() > 0.5
    for name, got, want in (("topi", r.topi, ji), ("pos", r.pos, jp),
                            ("keep", r.keep, jk), ("idx_buf", r.idx_buf, jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    _close(r.topv, jv, 1e-6, "topv")
    assert r.idx_buf.shape[1] == tmoe.capacity(n, k, e, cf)


def test_capacity_rounds_half_to_even():
    assert tmoe.capacity(4, 8, 64, 1.25) == 1          # 0.625
    assert tmoe.capacity(2, 2, 8, 1.0) == 1            # 0.5 -> 0 -> max 1
    assert tmoe.capacity(20, 2, 16, 1.0) == 2          # 2.5 -> 2
    assert tmoe.capacity(28, 2, 16, 1.0) == 4          # 3.5 -> 4


@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", 1.25),
                                     ("moonshot-v1-16b-a3b", 1.25),
                                     ("olmoe-1b-7b", 0.5)])
def test_moe_block_matches_jax(arch, cf):
    cfg = smoke_config(get_arch(arch))
    rng = np.random.default_rng(len(arch))
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    tree = {"router": _w(rng, d, e), "w_gate": _w(rng, e, d, f),
            "w_up": _w(rng, e, d, f), "w_down": _w(rng, e, f, d)}
    jp, tp = _params(tree)
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    want = jax.jit(lambda x, p: jmoe.moe_block(x, p, cfg,
                                               capacity_factor=cf))(
        jnp.asarray(x), jp)
    got = tmoe.moe_block(torch.from_numpy(x), tp, cfg, capacity_factor=cf)
    _close(got, want, 1e-5)
    r = tmoe.moe_route((torch.from_numpy(x).reshape(-1, d)
                        @ tp["router"]).float(), cfg.top_k, cf)
    if cf < 1:
        assert not r.keep.all()         # the capacity drops choices
    assert float(tmoe.moe_aux_loss(torch.zeros(3))) == float(
        jmoe.moe_aux_loss(jnp.zeros(3)))


# ---------------------------------------------------------------------------
# RG-LRU.
# ---------------------------------------------------------------------------

def _rglru_tree(rng, d):
    return {"w_a": _w(rng, d, d), "b_a": _w(rng, d, scale=0.1),
            "w_i": _w(rng, d, d), "b_i": _w(rng, d, scale=0.1),
            "lam": np.linspace(2.2, 6.9, d).astype(np.float32)
            + _w(rng, d, scale=0.3),
            "w_y": _w(rng, d, d), "w_x": _w(rng, d, d),
            "conv_w": _w(rng, 4, d), "w_o": _w(rng, d, d)}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_is_bit_equal_in_bf16(with_state):
    rng = np.random.default_rng(10)
    u = rng.standard_normal((2, 37, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    st = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ju, jw, js = (jnp.asarray(a, jnp.bfloat16) for a in (u, w, st))
    tu, tw, ts = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, w, st))
    jo, jst = jrg.causal_conv1d(ju, jw, js if with_state else None)
    to, tst = trg.causal_conv1d(tu, tw, ts if with_state else None)
    assert to.dtype == torch.bfloat16 and tst.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(_np(tst), _np(jst))


@pytest.mark.parametrize("t", [1, 2, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(t, with_h0):
    rng = np.random.default_rng(t)
    jp, tp = _params(_rglru_tree(rng, 32))
    u = rng.standard_normal((2, t, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 32)).astype(np.float32) if with_h0 else None
    jy, jh = jax.jit(jrg.rglru_scan)(jnp.asarray(u), jp,
                                     None if h0 is None else jnp.asarray(h0))
    ty, th = trg.rglru_scan(torch.from_numpy(u), tp,
                            None if h0 is None else torch.from_numpy(h0))
    assert th.dtype == torch.float32
    _close(ty, jy, 1e-5, "y")
    _close(th, jh, 1e-5, "h_T")


def test_associative_scan_equals_a_sequential_loop():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 77, 8)).astype(np.float64))
    b = torch.from_numpy(rng.standard_normal((2, 77, 8)))
    _, h = trg.associative_scan([a, b], dim=1)
    want, hp = [], torch.zeros(2, 8, dtype=torch.float64)
    for s in range(77):
        hp = a[:, s] * hp + b[:, s]
        want.append(hp)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_rglru_step_and_block_decode_match_jax():
    rng = np.random.default_rng(12)
    cfg = smoke_config(get_arch("recurrentgemma-2b"))
    jp, tp = _params(_rglru_tree(rng, cfg.d_model))
    u = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    jy, jh = jax.jit(jrg.rglru_step)(jnp.asarray(u), jp, jnp.asarray(h))
    ty, th = trg.rglru_step(torch.from_numpy(u), tp, torch.from_numpy(h))
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)
    # The whole block: a prefill, then one decode step from its state.
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    jblock = jax.jit(lambda x, p, c, h: jrg.rglru_block(
        x, p, cfg, conv_state=c, h0=h, return_state=True))
    jo, (jc, jh) = jblock(jnp.asarray(x[:, :8]), jp, None, None)
    to, (tc, th) = trg.rglru_block(torch.from_numpy(x[:, :8]), tp, cfg,
                                   return_state=True)
    _close(to, jo, 1e-5)
    jo, (jc, jh) = jblock(jnp.asarray(x[:, 8:]), jp, jc, jh)
    to, (tc, th) = trg.rglru_block(torch.from_numpy(x[:, 8:]), tp, cfg,
                                   conv_state=tc, h0=th, return_state=True)
    _close(to, jo, 1e-5)
    _close(tc, jc, 1e-5)
    _close(th, jh, 1e-5)


# ---------------------------------------------------------------------------
# xLSTM.
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, b, t, h, d):
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, t, h)) - 2))
                ).astype(np.float32)
    li = (rng.standard_normal((b, t, h)) * 0.5 - 1).astype(np.float32)
    return q, k, v, lf, li


@pytest.mark.parametrize("t", [48, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_jax(t, with_state):
    """T = 48 is three chunks of 16; T = 40 is not a multiple of 16, so
    the whole sequence is one chunk (the JAX package's rule)."""
    rng = np.random.default_rng(t + with_state)
    ins = _mlstm_inputs(rng, 2, t, 3, 8)
    st = ((rng.standard_normal((2, 3, 8, 8)) * 0.3).astype(np.float32),
          np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32))
    jo, (jS, jn) = jax.jit(lambda *a, state0: jxl.mlstm_chunkwise(
        *a, chunk=16, return_state=True, state0=state0))(
        *map(jnp.asarray, ins),
        state0=tuple(map(jnp.asarray, st)) if with_state else None)
    to, (tS, tn) = txl.mlstm_chunkwise(
        *map(torch.from_numpy, ins), chunk=16, return_state=True,
        state0=tuple(map(torch.from_numpy, st)) if with_state else None)
    _close(to, jo, 1e-5, "out")
    _close(tS, jS, 1e-5, "S")
    _close(tn, jn, 1e-5, "n")


def test_mlstm_step_and_block_match_jax():
    rng = np.random.default_rng(13)
    q, k, v, lf, li = (a[:, 0] for a in _mlstm_inputs(rng, 2, 1, 3, 8))
    st = ((rng.standard_normal((2, 3, 8, 8)) * 0.3).astype(np.float32),
          np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32))
    jo, (jS, jn) = jax.jit(jxl.mlstm_step)(
        *map(jnp.asarray, (q, k, v, lf, li)), tuple(map(jnp.asarray, st)))
    to, (tS, tn) = txl.mlstm_step(*map(torch.from_numpy, (q, k, v, lf, li)),
                                  tuple(map(torch.from_numpy, st)))
    for got, want in ((to, jo), (tS, jS), (tn, jn)):
        _close(got, want, 1e-5)

    cfg = smoke_config(get_arch("xlstm-350m"))
    d, di, h = cfg.d_model, cfg.mlstm_d_in, cfg.n_heads
    tree = {"w_up_x": _w(rng, d, di), "w_up_z": _w(rng, d, di),
            "w_q": _w(rng, di, di), "w_k": _w(rng, di, di),
            "w_v": _w(rng, di, di), "w_f": _w(rng, di, h),
            "b_f": _w(rng, h, scale=1.0), "w_i": _w(rng, di, h),
            "b_i": _w(rng, h, scale=1.0), "w_down": _w(rng, di, d)}
    jp, tp = _params(tree)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    jblock = jax.jit(lambda x, p, st: jxl.mlstm_block(
        x, p, cfg, state=st, return_state=True))
    jy, jst = jblock(jnp.asarray(x[:, :6]), jp, None)
    ty, tst = txl.mlstm_block(torch.from_numpy(x[:, :6]), tp, cfg,
                              return_state=True)
    _close(ty, jy, 1e-5)
    jy, jst = jblock(jnp.asarray(x[:, 6:]), jp, jst)
    ty, tst = txl.mlstm_block(torch.from_numpy(x[:, 6:]), tp, cfg,
                              state=tst, return_state=True)
    _close(ty, jy, 1e-5)
    _close(tst[0], jst[0], 1e-5)


def _slstm_tree(rng, cfg):
    d, h = cfg.d_model, cfg.n_heads
    ff = int(round(d * 4 / 3))
    return {"w_zifo": _w(rng, d, 4 * d), "r_kernel": _w(rng, h, d // h,
                                                        4 * d // h),
            "w_proj": _w(rng, d, d), "w_ff_gate": _w(rng, d, ff),
            "w_ff_up": _w(rng, d, ff), "w_ff_down": _w(rng, ff, d)}


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_and_block_match_jax(with_state):
    rng = np.random.default_rng(14 + with_state)
    cfg = smoke_config(get_arch("xlstm-350m"))
    jp, tp = _params(_slstm_tree(rng, cfg))
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    st = None
    if with_state:
        d = cfg.d_model
        st = [rng.standard_normal((2, d)).astype(np.float32),
              rng.standard_normal((2, d)).astype(np.float32),
              np.abs(rng.standard_normal((2, d))).astype(np.float32) + 1,
              rng.standard_normal((2, d)).astype(np.float32)]
    jy, jst = jxl.slstm_scan(jnp.asarray(x), jp, return_state=True,
                             state0=None if st is None else
                             tuple(map(jnp.asarray, st)))
    ty, tst = txl.slstm_scan(torch.from_numpy(x), tp, return_state=True,
                             state0=None if st is None else
                             tuple(map(torch.from_numpy, st)))
    _close(ty, jy, 1e-5, "y")
    for i, (g, w) in enumerate(zip(tst, jst)):
        _close(g, w, 1e-5, f"state {i}")
    _close(txl.slstm_block(torch.from_numpy(x), tp, cfg),
           jxl.slstm_block(jnp.asarray(x), jp, cfg), 1e-5, "block")


def test_slstm_refuses_a_carry_of_another_dtype():
    rng = np.random.default_rng(15)
    cfg = smoke_config(get_arch("xlstm-350m"))
    jp, tp = _params(_slstm_tree(rng, cfg))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    b, d = 2, cfg.d_model
    jst = (jnp.zeros((b, d), jnp.bfloat16),) + tuple(
        jnp.zeros((b, d), jnp.float32) for _ in range(3))
    with pytest.raises(TypeError, match="carry"):
        jxl.slstm_scan(jnp.asarray(x), jp, state0=jst)
    tst = txl.slstm_init_state(b, d, torch.bfloat16, "cpu")
    with pytest.raises(TypeError, match="carry"):
        txl.slstm_scan(torch.from_numpy(x), tp, state0=tst)


# ---------------------------------------------------------------------------
# layer_norm and the sliding window.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    tree = {"s": _w(rng, 64, scale=1.0), "b": _w(rng, 64, scale=1.0)}
    jp, tp = _params(tree, dtype)
    jx, tx = _params({"x": x}, dtype)
    got = TL.layer_norm(tx["x"], tp["s"], tp["b"])
    want = JL.layer_norm(jx["x"], jp["s"], jp["b"])
    assert got.dtype == tx["x"].dtype
    # bf16: one rounding of the f32 result.
    _close(got, want, 1e-6 if dtype == "f32" else 2 ** -7)


def _attn_tree(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    return {"wq": _w(rng, d, cfg.n_heads * hd),
            "wk": _w(rng, d, cfg.n_kv_heads * hd),
            "wv": _w(rng, d, cfg.n_kv_heads * hd),
            "wo": _w(rng, cfg.n_heads * hd, d)}


@pytest.mark.parametrize("plain", [False, True])
def test_windowed_attention_block_matches_jax(plain, monkeypatch):
    """A window takes the plain strategy whatever ``plain`` says: the
    flash op has no window and must not be called."""
    cfg = smoke_config(get_arch("recurrentgemma-2b"))
    assert cfg.attn_window == 32
    rng = np.random.default_rng(17)
    jp, tp = _params(_attn_tree(rng, cfg))
    x = rng.standard_normal((2, 72, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(72)[None], (2, 72))

    def no_flash(*a, **k):
        raise AssertionError("the flash op took a window")

    monkeypatch.setattr(ops, "flash_attention_op", no_flash)
    jblock = jax.jit(lambda x, p, pos, w: jatt.attention_block(
        x, p, cfg, pos, window=w), static_argnums=3)
    want = jblock(jnp.asarray(x), jp, jnp.asarray(pos), 32)
    got = tatt.attention_block(torch.from_numpy(x), tp, cfg,
                               torch.from_numpy(pos.copy()), window=32,
                               plain=plain)
    _close(got, want, 1e-5)
    causal = jblock(jnp.asarray(x), jp, jnp.asarray(pos), 0)
    assert np.abs(_np(want) - _np(causal)).max() > 1e-3


def test_attn_local_ring_decodes_past_its_wrap():
    """The smoke window of 32 rows, 40 decode steps of 3 lanes whose
    positions differ (a lane reset at step 5): the ring wraps, each slot
    holds RoPE'd keys of its position, and every step's output and the
    ring's rows equal the JAX package's."""
    cfg = dataclasses.replace(smoke_config(get_arch("recurrentgemma-2b")),
                              block_pattern=("attn_local",), n_layers=1)
    jcfg = dataclasses.replace(j_smoke_config(j_get_arch("recurrentgemma-2b")),
                               block_pattern=("attn_local",), n_layers=1)
    rng = np.random.default_rng(18)
    d = cfg.d_model
    tree = dict(_attn_tree(rng, cfg), norm1=_w(rng, d, scale=0.1),
                norm2=_w(rng, d, scale=0.1), w_gate=_w(rng, d, cfg.d_ff),
                w_up=_w(rng, d, cfg.d_ff), w_down=_w(rng, cfg.d_ff, d))
    jp, tp = _params(tree)
    jc = jdecode.init_cache(jcfg, 3, 64)["period"]["0_attn_local"]
    jc = {n: c[0] for n, c in jc.items()}
    tc = tdecode.init_cache(cfg, 3, 64, "cpu")["period"]["0_attn_local"]
    tc = {n: c[0] for n, c in tc.items()}
    assert tc["k"].shape[1] == 32
    jstep = jax.jit(lambda x, c, p: jdecode._decode_block(
        x, jp, jcfg, "attn_local", c, p))
    pos = np.array([0, 3, 0])
    for s in range(40):
        if s == 5:          # lane 2 starts again, as after reset_lane
            pos[2] = 0
            jc = {n: c.at[2].set(0) for n, c in jc.items()}
            for c in tc.values():
                c[2] = 0
        x = rng.standard_normal((3, 1, d)).astype(np.float32)
        jx, jc = jstep(jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32))
        tx = tdecode._decode_block(torch.from_numpy(x), tp, cfg, "attn_local",
                                   tc, torch.from_numpy(pos.copy()))
        _close(tx, jx, 1e-5, f"step {s}")
        pos += 1
    assert pos.max() > 32
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), atol=2 ** -6,
                                   rtol=2 ** -7)   # one bf16 rounding apart
