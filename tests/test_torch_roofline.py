"""The port's op counter (``launch/op_cost.py``) and H100 roofline
(``launch/roofline.py``) against the JAX package's HLO cost model.

* FLOPs of ``tests/test_roofline.py``'s three programs (a chain of four
  256^2 products, a loop of 8 and nested loops of 3 x 4 of 128^2 ones):
  equal to JAX's ``analyze_text`` FLOPs exactly;
* a redistribution on a 4-rank fake mesh counts its collective's bytes
  under the right kind; a replicated product on a 16 x 16 fake mesh
  counts once on every device (the global op's FLOPs, not a 256th);
* the H100 ``Roofline``'s terms, bottleneck and ``mfu_bound``;
* a smoke train step's FLOPs (remat "full", recompute included in both)
  within 1 % of JAX's ``hlo_cost`` FLOPs of the same step;
* the flash op's registered formula: causal, 2 * B * H * T^2 * D.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze_text
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_cost import OpCounter, count


@pytest.fixture()
def fake_mesh():
    """Meshes over fake ranks; the process group is destroyed after."""
    from repro_torch.launch import mesh as M
    yield lambda shape, names: M._fake_mesh(shape, names, "cpu")
    M.teardown()


def _jax_flops(fn, shape):
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    return analyze_text(jax.jit(fn).lower(x).compile().as_text()).flops


def _chain(a, mm):
    for _ in range(4):
        a = mm(a, a)
    return a


def _loop(a, mm):
    for _ in range(8):
        a = mm(a, a)
    return a


def _nested(a, mm):
    for _ in range(3):
        for _ in range(4):
            a = mm(a, a)
    return a


def _scan(n):
    def f(a):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, ()), a, None, length=n)
        return y
    return f


def _nested_scan(a):
    def outer(c, _):
        y, _ = jax.lax.scan(lambda d, _: (d @ d, ()), c, None, length=4)
        return y, ()
    y, _ = jax.lax.scan(outer, a, None, length=3)
    return y


PROGRAMS = {
    "chain_256": (_chain, lambda a: _chain(a, jnp.matmul), 256),
    "loop_8": (_loop, _scan(8), 128),
    "nested_3x4": (_nested, _nested_scan, 128),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_flops_equal_jax_hlo_cost(name):
    ours, jax_fn, n = PROGRAMS[name]
    _, c = count(ours, torch.ones(n, n), torch.matmul)
    assert c.flops == _jax_flops(jax_fn, (n, n))


def test_redistribute_counts_its_collective(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_mesh((4,), ("data",))
    x = distribute_tensor(torch.ones(64, 32), mesh, [Shard(0)])
    with OpCounter() as c:
        y = x.redistribute(mesh, [Replicate()])
    assert tuple(y.to_local().shape) == (64, 32)
    rep = c.report()
    assert rep.coll_counts["all-gather"] == 1
    assert rep.coll_breakdown["all-gather"] == 64 * 32 * 4
    assert rep.coll_bytes == 64 * 32 * 4
    with OpCounter() as c:
        z = y.redistribute(mesh, [Shard(1)]).redistribute(mesh, [Shard(0)])
    assert z.to_local().shape == (16, 32)
    assert c.report().coll_counts["all-to-all"] >= 1 or \
        c.report().coll_counts["all-gather"] >= 1


def test_replicated_product_counts_once_per_device(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import fake_mode
    mesh = fake_mesh((16, 16), ("data", "model"))
    with fake_mode():
        x = torch.empty(64, 4096, dtype=torch.bfloat16)
        w = torch.empty(4096, 4096, dtype=torch.bfloat16)
        xr = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        wr = distribute_tensor(w, mesh, [Replicate(), Replicate()])
        ws = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
        with OpCounter() as rep:
            xr @ wr.t()
        with OpCounter() as sh:
            xr @ ws.t()
    assert rep.flops == 2 * 64 * 4096 * 4096
    assert sh.flops == 2 * 64 * 4096 * 4096 // 16


def test_h100_roofline_terms_and_bottleneck():
    assert rl.PEAK_FLOPS == 989e12 and rl.HBM_BW == 3.35e12
    r = rl.Roofline(flops_per_device=rl.PEAK_FLOPS,
                    bytes_per_device=rl.HBM_BW * 2,
                    coll_bytes_per_device=0.0, coll_breakdown={},
                    n_devices=4, model_flops=4 * rl.PEAK_FLOPS * 0.5,
                    fused_bytes_per_device=rl.HBM_BW * 2)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.bottleneck == "memory"
    assert r.step_time == pytest.approx(2.0)
    assert r.mfu_bound == pytest.approx(0.25)
    # A collective within a node of 8 runs at NVLink's rate, beyond one
    # at the network's.
    c = rl.Roofline(0.0, 0.0, rl.NVLINK_BW, {}, 8, group=8)
    assert c.t_collective == pytest.approx(1.0)
    assert c.bottleneck == "collective"
    assert rl.Roofline(0.0, 0.0, rl.NET_BW, {}, 16,
                       group=16).t_collective == pytest.approx(1.0)
    assert set(r.row()) >= {"t_compute_s", "t_memory_fused_s", "bottleneck",
                            "mfu_bound", "useful_flops_frac"}


def test_flash_op_flop_formula():
    from repro_torch.kernels import ops
    q = torch.randn(2, 64, 4, 32)
    kv = torch.randn(2, 64, 2, 32)[:, :, :, None].expand(2, 64, 2, 2, 32)
    _, c = count(ops.flash_attention_op, q, kv, kv)
    assert c.flops == 2 * 2 * 4 * 64 * 64 * 32
    assert c.by_op["ditto.flash_attention.default"][0] == 1


def test_smoke_train_step_flops_match_hlo_cost():
    """One smoke train step (2 microbatches, remat "full"): the counter's
    FLOPs against JAX's loop-aware HLO count of the same step, within 1 %
    (XLA's dots and PyTorch's products count the same matmuls; the two
    differ in which tiny products each backward forms)."""
    from repro.configs import get_arch as j_arch
    from repro.configs.registry import smoke_config as j_smoke
    from repro.models.model import abstract_params as j_abstract
    from repro.train.optimizer import AdamWConfig as JCfg
    from repro.train.optimizer import OptState as JOpt
    from repro.train.optimizer import make_train_step as j_step
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt, make_train_step

    b, t = 4, 32
    jcfg = j_smoke(j_arch("smollm-135m"))
    params = j_abstract(jcfg, jnp.float32)
    f32 = lambda tr: jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), tr)
    opt = JOpt(jax.ShapeDtypeStruct((), jnp.int32), f32(params),
               f32(params), f32(params))
    ins = {k: jax.ShapeDtypeStruct((b, t), jnp.int32)
           for k in ("tokens", "labels")}
    step = j_step(jcfg, JCfg(), n_microbatches=2, remat="full")
    want = analyze_text(jax.jit(step).lower(params, opt, ins).compile()
                        .as_text()).flops

    cfg = smoke_config(get_arch("smollm-135m"))
    p = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (b, t)))
    tstep = make_train_step(cfg, AdamWConfig(), n_microbatches=2,
                            remat="full")
    _, c = count(tstep, p, init_opt(p), {"tokens": toks, "labels": toks})
    assert c.flops == pytest.approx(want, rel=0.01)
