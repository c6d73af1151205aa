"""The port's training path (``repro_torch.models.forward`` with labels
and remat, ``repro_torch.train`` and ``repro_torch.launch.train``)
against the JAX package's, on the CPU.

Setup: ``smoke_config(smollm-135m)``, B = 8, T = 32, as
``tests/test_train.py``; params from the JAX package's ``init_params``
carried across with ``params_from_numpy``, tokens from a numpy seed.
Each JAX step is jitted once per module.

Tolerances:

* ``logits_and_xent``: f32 within 1e-6 relative (the same f32
  operations, the vocab sum in another order); bf16 within one bf16
  rounding (2^-8 relative: the logits are rounded to bf16 on both
  sides, their products summed in another order).
* ``forward`` with labels, f32: the loss within 1e-5 relative;
  gradients (``torch.autograd`` against ``jax.grad``) within rtol =
  atol = 1e-4, the port's whole-forward tolerance.  Every ``remat`` mode
  is bit-equal to ``"none"`` in loss and gradients (recompute is
  deterministic on the CPU).
* One ``make_train_step`` in f32, at 1 and 4 microbatches, from the
  same params and ``OptState``: loss, ``master``, ``m`` and ``v`` within
  1e-5 (abs and rel); after five steps within 1e-4.  In bf16, JAX's own
  bounds: the loss within 2e-2.
* ``lr_at``: within 1 ulp of JAX's at every step up to ``total_steps``.
* ``compress``, ``decompress`` and ``compressed_allreduce(group=None)``:
  bit-equal to JAX's as its tests call them, op by op (int8 values,
  scales and error).  The group path (2 gloo
  ranks in subprocesses, 60 s each): equal to the numpy reckoning.
* Checkpoints across packages, the straggler triggers, the synthetic
  batches and the port's own resume: equal.
"""

import os
import shutil
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.launch import train as j_launch
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models.model import forward as j_forward
from repro.train import AdamWConfig as JAdamW
from repro.train import CheckpointManager as JCkpt
from repro.train import OptState as JOptState
from repro.train import grad_compress as j_gc
from repro.train import init_opt as j_init_opt
from repro.train import loop as j_loop
from repro.train import make_train_step as j_make_train_step
from repro.train.optimizer import lr_at as j_lr_at
from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import train as t_launch
from repro_torch.models import layers as TL
from repro_torch.models.model import forward, params_from_numpy
from repro_torch.train import (AdamWConfig, CheckpointManager, OptState,
                               init_opt, make_train_step)
from repro_torch.train import grad_compress as t_gc
from repro_torch.train import loop as t_loop
from repro_torch.train.optimizer import (lr_at, opt_from_numpy,
                                         opt_to_numpy, tree_leaves)

B, T = 8, 32
CPU = torch.device("cpu")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where PyTorch's default thread pool
    oversubscribes them (25 smoke steps took 0.7 s alone and 35 s in
    that run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    cfg = smoke_config(get_arch("smollm-135m"))
    jcfg = j_smoke_config(j_get_arch("smollm-135m"))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    params = {k: jax.tree.map(np.asarray,
                              j_init_params(jax.random.PRNGKey(0), jcfg,
                                            dtype=d))
              for k, d in JDT.items()}
    return cfg, jcfg, batch, params


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _tparams(params, kind="f32"):
    return params_from_numpy(params[kind], CPU)


# ---------------------------------------------------------------------------
# The loss and its gradients.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_xent_matches_jax(dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    table = (rng.standard_normal((256, 32)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 256, (2, 16))
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    got = TL.logits_and_xent(torch.from_numpy(x).to(td),
                             torch.from_numpy(table).to(td),
                             torch.from_numpy(labels))
    want = JL.logits_and_xent(jnp.asarray(x, JDT[dtype]),
                              jnp.asarray(table, JDT[dtype]),
                              jnp.asarray(labels, jnp.int32))
    assert got.dtype == torch.float32
    tol = 1e-6 if dtype == "f32" else 2.0 ** -8
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=0)


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    cfg, jcfg, batch, params = setup
    jp = jax.tree.map(jnp.asarray, params["f32"])
    jb = _jbatch(batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward(p, jcfg, tokens=jb["tokens"],
                            labels=jb["labels"])))(jp)
    return float(loss), jax.tree.leaves(grads)


def _port_loss_and_grads(setup, remat="none"):
    cfg, _, batch, params = setup
    tp = _tparams(params)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_()
    tb = _tbatch(batch)
    loss = forward(tp, cfg, tokens=tb["tokens"], labels=tb["labels"],
                   remat=remat)
    return loss, torch.autograd.grad(loss, leaves)


def test_forward_with_labels_matches_jax(setup, jax_loss_and_grads):
    want_loss, want_grads = jax_loss_and_grads
    loss, grads = _port_loss_and_grads(setup)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5,
                               atol=0)
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _close(g, w, 1e-4, f"gradient leaf {i}")


@pytest.mark.parametrize("remat", ["full", "dots", "save_outs"])
def test_remat_is_bit_equal_to_none(setup, remat):
    loss0, grads0 = _port_loss_and_grads(setup)
    loss, grads = _port_loss_and_grads(setup, remat)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


def test_unknown_remat_raises(setup):
    with pytest.raises(ValueError, match="remat"):
        _port_loss_and_grads(setup, "everything")


def test_forward_without_labels_is_unchanged_by_remat(setup):
    cfg, _, batch, params = setup
    tp = _tparams(params)
    tok = _tbatch(batch)["tokens"]
    h0 = forward(tp, cfg, tokens=tok)
    assert torch.equal(forward(tp, cfg, tokens=tok, remat="full"), h0)


@pytest.mark.parametrize("grad_input", ["q", "k", "v"])
def test_flash_op_refuses_inputs_that_require_grad(grad_input):
    qkv = {n: torch.randn(1, 16, 2, 8) for n in "qkv"}
    qkv[grad_input].requires_grad_()
    with pytest.raises(RuntimeError, match="full_attention"):
        ops.flash_attention_op(qkv["q"], qkv["k"], qkv["v"])
    with torch.no_grad():       # no grad mode: the forward runs
        out = ops.flash_attention_op(qkv["q"], qkv["k"], qkv["v"])
    assert out.shape == (1, 16, 2, 8) and out.grad_fn is None


def test_long_sequences_train_through_chunked_attention(setup, monkeypatch):
    """``attention_block(plain=True)`` takes ``full_attention`` up to 8192
    tokens and ``chunked_attention`` above, as the JAX package's does;
    ``plain=False`` takes the flash op."""
    from repro_torch.models import attention as tatt
    cfg, _, _, params = setup
    called = []
    for name in ("full_attention", "chunked_attention"):
        monkeypatch.setattr(tatt, name, lambda q, k, v, _n=name, **kw:
                            called.append((_n, q.shape[1]))
                            or torch.zeros_like(q))
    monkeypatch.setattr(tatt.ops, "flash_attention_op",
                        lambda q, k, v: called.append(("flash", q.shape[1]))
                        or torch.zeros_like(q))
    bp = {n: w[0] for n, w in _tparams(params)["period"]["0_attn"].items()}
    for t, plain in ((8192, True), (8193, True), (8193, False)):
        x = torch.zeros((1, t, cfg.d_model))
        tatt.attention_block(x, bp, cfg, torch.arange(t)[None], plain=plain)
    assert called == [("full_attention", 8192), ("chunked_attention", 8193),
                      ("flash", 8193)]


# ---------------------------------------------------------------------------
# The optimizer and the train step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's f32 train step at 1 and 4 microbatches, five steps each:
    (loss, opt as numpy) after every step."""
    cfg, jcfg, batch, params = setup
    ocfg = JAdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    out = {}
    jb = _jbatch(batch)
    for n_mb in (1, 4):
        step = jax.jit(j_make_train_step(jcfg, ocfg, n_microbatches=n_mb,
                                         remat="none"))
        p = jax.tree.map(jnp.asarray, params["f32"])
        o = j_init_opt(p)
        trail = []
        for _ in range(5):
            p, o, loss = step(p, o, jb)
            trail.append((float(loss), jax.tree.map(np.asarray, o)))
        out[n_mb] = trail
    return out


def _opt_leaves(o):
    return [np.asarray(o.step)] + [
        _np(x) for t in (o.master, o.m, o.v) for x in tree_leaves(t)]


def _jax_opt_leaves(o):
    return [np.asarray(o.step)] + [np.asarray(x) for t in (o.master, o.m, o.v)
                                   for x in jax.tree.leaves(t)]


@pytest.mark.parametrize("n_mb", [1, 4])
def test_train_step_matches_jax(setup, jax_steps, n_mb):
    """Loss, m and v within the tolerance at every element; the master
    within it where Adam's normalised step is well conditioned (JAX's
    sqrt(v_hat) at least 100 eps), and elsewhere within the step's
    reach, 2 lr summed over the steps: there u = m_hat / (sqrt(v_hat) +
    eps) turns the gradients' last-bit differences (~1e-9 absolute, see
    ``test_forward_with_labels_matches_jax``) into differences of order
    one.  ``test_adamw_update_matches_jax`` holds the update itself to
    the tolerance at every element, from the same gradients."""
    cfg, _, batch, params = setup
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, ocfg, n_microbatches=n_mb, remat="none")
    p = _tparams(params)
    o = init_opt(p)
    tb = _tbatch(batch)
    reach = 0.0
    for i, (want_loss, want_opt) in enumerate(jax_steps[n_mb]):
        p, o, loss = step(p, o, tb)
        reach += 2 * float(lr_at(ocfg, torch.tensor(i + 1.0)))
        if i not in (0, 4):
            continue
        tol = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(float(loss), want_loss, rtol=tol, atol=tol)
        got, want = _opt_leaves(o), _jax_opt_leaves(want_opt)
        assert int(got[0]) == int(want[0]) == i + 1
        k = len(tree_leaves(o.master))
        bc2 = 1 - np.float32(ocfg.b2) ** np.float32(i + 1)
        for j in range(k):
            g_m, w_m = got[1 + j], want[1 + j]
            for g, w, what in ((got[1 + k + j], want[1 + k + j], "m"),
                               (got[1 + 2 * k + j], want[1 + 2 * k + j], "v")):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=f"step {i + 1} {what} {j}")
            good = np.sqrt(want[1 + 2 * k + j] / bc2) >= 100 * ocfg.eps
            np.testing.assert_allclose(g_m[good], w_m[good], rtol=tol,
                                       atol=tol,
                                       err_msg=f"step {i + 1} master {j}")
            assert np.abs(g_m - w_m).max() <= reach + tol
            assert good.mean() > 0.99
    assert p["embed"].dtype == torch.float32


def test_adamw_update_matches_jax(setup, jax_loss_and_grads):
    """The update alone, from JAX's gradients carried across, twice:
    master, m and v within 1e-5 at every element."""
    from repro.train.optimizer import adamw_update as j_update
    from repro_torch.train.optimizer import adamw_update
    _, _, _, params = setup
    jcfg = JAdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jg = jax.tree.unflatten(jax.tree.structure(params["f32"]),
                            jax_loss_and_grads[1])
    tg = params_from_numpy(jax.tree.map(np.asarray, jg), CPU)
    jo = j_init_opt(jax.tree.map(jnp.asarray, params["f32"]))
    to = opt_from_numpy(jax.tree.map(np.asarray, jo), CPU)
    jup = jax.jit(lambda o, g: j_update(o, g, jcfg))
    for _ in range(2):
        jo, to = jup(jo, jg), adamw_update(to, tg, cfg)
        for g, w in zip(_opt_leaves(to), _jax_opt_leaves(jo)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_bf16_train_step_matches_jax_within_its_bounds(setup):
    cfg, jcfg, batch, params = setup
    jstep = j_make_train_step(jcfg, JAdamW(lr=1e-3, warmup_steps=1),
                              remat="none")
    jp = jax.tree.map(jnp.asarray, params["bf16"])
    _, _, jloss = jax.jit(jstep)(jp, j_init_opt(jp), _jbatch(batch))
    tp = _tparams(params, "bf16")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           remat="none")
    p, o, loss = step(tp, init_opt(tp), _tbatch(batch))
    assert abs(float(loss) - float(jloss)) < 2e-2
    assert p["embed"].dtype == torch.bfloat16
    assert all(torch.isfinite(x).all() for x in tree_leaves(p))


@pytest.mark.parametrize("ocfg", [
    dict(), dict(warmup_steps=20, total_steps=200, lr=3e-3),
    dict(warmup_steps=0, total_steps=50, min_lr_frac=0.0)])
def test_lr_at_within_one_ulp_of_jax(ocfg):
    cfg, jcfg = AdamWConfig(**ocfg), JAdamW(**ocfg)
    steps = np.arange(cfg.total_steps + 1, dtype=np.float32)
    want = np.asarray(jax.jit(lambda s: j_lr_at(jcfg, s))(steps))
    got = lr_at(cfg, torch.from_numpy(steps)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, (ulps.max(), int(np.argmax(ulps)))
    one = lr_at(cfg, torch.tensor(float(cfg.total_steps // 3)))
    assert one.dtype == torch.float32 and one.dim() == 0


def test_opt_state_carries_across(setup):
    _, _, _, params = setup
    jo = jax.tree.map(np.asarray, j_init_opt(
        jax.tree.map(jnp.asarray, params["bf16"])))
    to = opt_from_numpy(jo, CPU)
    assert to.step.dtype == torch.int32
    back = JOptState(*opt_to_numpy(to))
    for a, b in zip(jax.tree.leaves(jo), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The JAX package's training tests, on the port (tests/test_train.py).
# ---------------------------------------------------------------------------

def _port_setup(setup, kind="bf16"):
    cfg, _, batch, params = setup
    p = _tparams(params, kind)
    return cfg, p, init_opt(p), _tbatch(batch)


def test_port_loss_decreases(setup):
    cfg, params, opt, batch = _port_setup(setup)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=100,
                                            weight_decay=0.0), remat="none")
    losses = []
    for _ in range(25):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()


def test_port_grad_accumulation_equivalence(setup):
    cfg, params, opt, batch = _port_setup(setup)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, weight_decay=0.0)
    _, o1, l1 = make_train_step(cfg, ocfg, remat="none")(params, opt, batch)
    _, o4, l4 = make_train_step(cfg, ocfg, n_microbatches=4,
                                remat="none")(params, opt, batch)
    assert abs(float(l1) - float(l4)) < 2e-2
    d = max(float((a - b).abs().max())
            for a, b in zip(tree_leaves(o1.master), tree_leaves(o4.master)))
    assert d < 5e-3, d


def _state_leaves(state):
    return [state["opt"].step] + [
        x for t in (state["params"], state["opt"].master, state["opt"].m,
                    state["opt"].v) for x in tree_leaves(t)]


def test_port_checkpoint_roundtrip_and_gc(setup, tmp_path):
    _, params, opt, _ = _port_setup(setup)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    state = {"params": params, "opt": opt}
    for step_i in (1, 2, 3):
        mgr.save(step_i, state)
    mgr.wait()
    assert mgr.latest_step() == 3
    assert len(mgr._list()) == 2  # keep=2 garbage collection
    restored = mgr.restore(3, state)
    assert isinstance(restored["opt"], OptState)
    for a, b in zip(_state_leaves(state), _state_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_resume_training(setup, tmp_path):
    """Crash/restart: resuming from a checkpoint continues identically."""
    cfg, params, opt, batch = _port_setup(setup)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            weight_decay=0.0), remat="none")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    for _ in range(3):
        params, opt, _ = step(params, opt, batch)
    mgr.save(3, {"params": params, "opt": opt})
    p_direct, _, _ = step(params, opt, batch)
    restored = mgr.restore(3, {"params": params, "opt": opt})
    p_res, _, _ = step(restored["params"], restored["opt"], batch)
    for a, b in zip(tree_leaves(p_direct), tree_leaves(p_res)):
        assert torch.equal(a, b)


def test_train_loop_resumes_bit_identically_and_drains(setup, tmp_path):
    """``TrainLoop``: six steps with a checkpoint every three; a second
    loop resuming from step 3 ends at the same params; a SIGTERM at
    step 2 drains with one final checkpoint."""
    cfg, params, opt, _ = _port_setup(setup)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=6), remat="full")
    batches = t_launch.synthetic_batches(cfg, 4, 16, device=CPU)
    a, b, c = (str(tmp_path / n) for n in "abc")
    loop = t_loop.TrainLoop(step, a, ckpt_every=3)
    p6, _ = loop.run(params, opt, batches, 6, log=lambda *_: None)
    assert sorted(loop.mgr._list()) == [3, 6] and len(loop.losses) == 6
    os.makedirs(b)
    for f in ("step_0000000003.npz", "step_0000000003.npz.json"):
        shutil.copy(os.path.join(a, f), b)
    again = t_loop.TrainLoop(step, b, ckpt_every=3)
    logs = []
    p6b, _ = again.run(params, opt, batches, 6, log=logs.append)
    assert "resumed from checkpoint step 3" in logs[0]
    assert again.losses == loop.losses[3:]
    for x, y in zip(tree_leaves(p6), tree_leaves(p6b)):
        assert torch.equal(x, y)

    def stop_at_2(p, o, bt, _n=[0]):
        _n[0] += 1
        if _n[0] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(p, o, bt)
    drained = t_loop.TrainLoop(stop_at_2, c, ckpt_every=50)
    drained.run(params, opt, batches, 6, log=logs.append)
    assert drained.mgr._list() == [2] and len(drained.losses) == 2
    assert logs[-1] == "[loop] SIGTERM: drained at step 2"


# ---------------------------------------------------------------------------
# Checkpoints across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_jax_checkpoint_restores_in_the_port(setup, tmp_path, kind):
    _, _, _, params = setup
    jp = jax.tree.map(jnp.asarray, params[kind])
    jstate = {"params": jp, "opt": j_init_opt(jp)}
    jstate["opt"] = jstate["opt"]._replace(
        step=jnp.int32(7), m=jax.tree.map(lambda x: x + 0.25,
                                          jstate["opt"].m))
    JCkpt(str(tmp_path), async_write=False).save(7, jstate)
    tp = _tparams(params, kind)
    like = {"params": tp, "opt": init_opt(tp)}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    got = mgr.restore(7, like)
    want = jax.tree.leaves(jstate)
    assert len(want) == len(_state_leaves(got))
    order = [got["opt"].step] + [x for t in got["opt"][1:]
                                 for x in tree_leaves(t)] + tree_leaves(
                                     got["params"])
    for g, w in zip(order, want):
        assert g.dtype == {jnp.dtype("bfloat16"): torch.bfloat16,
                           jnp.dtype("float32"): torch.float32,
                           jnp.dtype("int32"): torch.int32}[w.dtype]
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax(setup, tmp_path, kind):
    cfg, _, batch, params = setup
    tp = _tparams(params, kind)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                           remat="none")
    p, o, _ = step(tp, init_opt(tp), _tbatch(batch))
    CheckpointManager(str(tmp_path), async_write=False).save(
        1, {"params": p, "opt": o})
    jp = jax.tree.map(jnp.asarray, params[kind])
    like = {"params": jp, "opt": j_init_opt(jp)}
    got = JCkpt(str(tmp_path)).restore(1, like)
    assert int(got["opt"].step) == 1
    for g, w in zip(jax.tree.leaves(got["params"]), tree_leaves(p)):
        assert g.dtype == JDT[kind]
        np.testing.assert_array_equal(_np(g), _np(w))
    for g, w in zip(jax.tree.leaves(got["opt"].m), tree_leaves(o.m)):
        np.testing.assert_array_equal(_np(g), _np(w))
    manifest = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert manifest == ["step_0000000001.npz.json"]


# ---------------------------------------------------------------------------
# Gradient compression.
# ---------------------------------------------------------------------------

def _grad(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * rng.exponential(1, n)).astype(np.float32)


def _bits_equal(got, want):
    got, want = _np_any(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _np_any(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("n", [4096, 5000, 1000])
def test_compress_is_bit_equal_to_jax(n):
    jst, tst = j_gc.init_compress(n), t_gc.init_compress(n)
    for seed in (0, 1):       # the second round carries the error back
        g = _grad(seed + n, n)
        jq, js, jst = j_gc.compress(jnp.asarray(g), jst)
        tq, ts, tst = t_gc.compress(torch.from_numpy(g), tst)
        _bits_equal(tq, jq)
        _bits_equal(ts, js)
        _bits_equal(tst.error, jst.error)
        _bits_equal(t_gc.decompress(tq, ts, n), j_gc.decompress(jq, js, n))


@pytest.mark.parametrize("n", [4096, 5000])
def test_compressed_allreduce_without_group_is_bit_equal_to_jax(n):
    g = _grad(7, n)
    jd, jst = j_gc.compressed_allreduce(jnp.asarray(g), j_gc.init_compress(n))
    td, tst = t_gc.compressed_allreduce(torch.from_numpy(g),
                                        t_gc.init_compress(n))
    _bits_equal(td, jd)
    _bits_equal(tst.error, jst.error)


def test_port_compress_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    deq, st = t_gc.compressed_allreduce(g, t_gc.init_compress(4096))
    err = (deq - g).abs()
    scale = float(g.abs().max()) / 127.0
    assert float(err.max()) <= scale * 1.01
    np.testing.assert_allclose(st.error.numpy(), (g - deq).numpy(),
                               atol=1e-6)


def test_port_compress_error_feedback_converges():
    g = torch.from_numpy(_grad(1, 2048))
    st = t_gc.init_compress(2048)
    acc = torch.zeros_like(g)
    for _ in range(20):
        deq, st = t_gc.compressed_allreduce(g, st)
        acc = acc + deq
    np.testing.assert_allclose((acc / 20).numpy(), g.numpy(),
                               atol=float(g.abs().max()) / 127.0)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train import grad_compress as gc
    rank, port, n, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    rng = np.random.default_rng(100 + rank)
    g = (rng.normal(size=n) * (1 + 3 * rank)).astype(np.float32)
    err = (rng.normal(size=n) * 1e-3).astype(np.float32)
    mean, st = gc.compressed_allreduce(torch.from_numpy(g),
                                       gc.CompressState(torch.from_numpy(err)),
                                       group=dist.group.WORLD)
    np.savez(out, g=g, err=err, mean=mean.numpy(), new_err=st.error.numpy())
    dist.destroy_process_group()
""")


def test_compressed_allreduce_over_a_gloo_group(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n = 3000
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    outs = [str(tmp_path / f"r{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(port), str(n), outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=60)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            p.kill()
    r = [np.load(o) for o in outs]
    pad = (-n) % t_gc.BLOCK

    def blocks(x):
        return np.pad(x, (0, pad)).reshape(-1, t_gc.BLOCK)
    ge = [blocks(x["g"] + x["err"]) for x in r]
    scale = np.maximum.reduce([np.maximum(
        np.abs(x).max(axis=1, keepdims=True) / np.float32(127),
        np.float32(1e-12)) for x in ge])
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int32) for x in ge]
    total = ((q[0] + q[1]).astype(np.float32) * scale).reshape(-1)[:n]
    want = total / np.float32(2)
    for rank, x in enumerate(r):
        np.testing.assert_array_equal(x["mean"], want)
        local = (q[rank].astype(np.float32) * scale).reshape(-1)[:n]
        np.testing.assert_array_equal(
            x["new_err"], (x["g"] + x["err"]) - local)


# ---------------------------------------------------------------------------
# The loop's straggler policy and the launcher's data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(factor=1.5, window=10,
                                             min_samples=3)])
def test_straggler_policy_triggers_as_jax(kw):
    rng = np.random.default_rng(3)
    times = rng.lognormal(-3, 0.4, 400)
    times[rng.integers(0, 400, 30)] *= 6
    jp, tp = j_loop.StragglerPolicy(**kw), t_loop.StragglerPolicy(**kw)
    got = [tp.observe(float(t)) for t in times]
    assert got == [jp.observe(float(t)) for t in times]
    assert tp.triggers == jp.triggers > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_jax(setup, seed):
    cfg, jcfg, _, _ = setup
    jget = j_launch.synthetic_batches(jcfg, 4, 24, seed=seed)
    tget = t_launch.synthetic_batches(cfg, 4, 24, seed=seed, device=CPU)
    for i in (0, 3):
        jb, tb = jget(i), tget(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    loop = t_launch.main(["--device", "cpu", "--steps", "12", "--batch",
                          "4", "--seq", "16", "--ckpt", str(tmp_path),
                          "--ckpt-every", "6", "--microbatches", "2"])
    assert len(loop.losses) == 12 and np.isfinite(loop.losses).all()
    assert sorted(loop.mgr._list()) == [6, 12]
    assert "final loss" in capsys.readouterr().out
