"""The port's sharding (``repro_torch.models.sharding``) and spec trees
against the JAX package's, at full configs, with nothing compiled.

* ``build_param_specs``, ``zero_specs`` (data=16) and ``cache_specs``
  (decode_32k, long_500k) of all ten archs at ``model_shards=16``: the
  same entries leaf by leaf (a spec is compared as its tuple of
  entries);
* the token resolution of ``maybe_shard`` (JAX's read off its
  ``with_sharding_constraint`` call) and of ``spec`` on 2x2 and 2x2x2
  meshes, dropped axes, 'dp' and ``set_dp_axes`` included, and the
  placements ``maybe_shard`` gives on a 2x2 fake-rank mesh;
* without a mesh ``maybe_shard`` returns its input.
"""

from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import registry as j_reg
from repro.models import model as j_model
from repro.models import sharding as j_sh
from repro.serve import decode as j_decode
from repro.train import optimizer as j_opt
from repro_torch.configs import registry as t_reg
from repro_torch.models import model as t_model
from repro_torch.models import sharding as t_sh
from repro_torch.serve import decode as t_decode
from repro_torch.train import optimizer as t_opt

ARCHS = t_reg.ARCHS


@pytest.fixture()
def fake_mesh():
    """Make (data, model)-style meshes over fake ranks in this process;
    the process group is destroyed after the test (workers run many
    files)."""
    from repro_torch.launch import mesh as M
    yield lambda shape, names: M._fake_mesh(shape, names, "cpu")
    M.teardown()


def _norm(spec) -> tuple:
    """A spec's entries, a one-axis tuple as its axis (JAX's
    ``PartitionSpec`` stores ``('data',)`` as ``'data'``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: _norm(tree)}


def _same_specs(t_tree, j_tree):
    t, j = _flat(t_tree), _flat(j_tree)
    assert t.keys() == j.keys()
    bad = {k: (t[k], j[k]) for k in t if t[k] != j[k]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero_specs_match_jax(arch):
    t_cfg, j_cfg = t_reg.get_arch(arch), j_reg.get_arch(arch)
    t_specs = t_model.build_param_specs(t_cfg, model_shards=16)
    j_specs = j_model.build_param_specs(j_cfg, model_shards=16)
    _same_specs(t_specs, j_specs)
    # zero_specs reads the mesh's axes and the data axis's size only.
    t_mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                             shape=(16, 16))
    j_mesh = SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 16, "model": 16})
    t_z = t_opt.zero_specs(t_specs, t_model.abstract_params(t_cfg), t_mesh)
    j_z = j_opt.zero_specs(j_specs, j_model.abstract_params(j_cfg), j_mesh)
    _same_specs(t_z, j_z)
    # The abstract params: the JAX tree's shapes, with no values.
    shapes = lambda tree: {k: tuple(v) for k, v in _flat(tree).items()}
    t_abs = t_model.abstract_params(t_cfg)
    assert all(x.device.type == "meta"
               for x in jax.tree_util.tree_leaves(
                   t_abs, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert shapes(jax.tree.map(lambda x: x.shape, t_abs,
                               is_leaf=lambda x: isinstance(x, torch.Tensor))
                  ) == shapes(jax.tree.map(lambda x: x.shape,
                                           j_model.abstract_params(j_cfg)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ("decode_32k", "long_500k"))
def test_cache_specs_match_jax(arch, shape):
    s = t_reg.get_shape(shape)
    t_cfg, j_cfg = t_reg.get_arch(arch), j_reg.get_arch(arch)
    _same_specs(t_decode.cache_specs(t_cfg, s.global_batch, s.seq_len, 16),
                j_decode.cache_specs(j_cfg, s.global_batch, s.seq_len, 16))
    t_abs = t_decode.abstract_cache(t_cfg, s.global_batch, s.seq_len)
    j_abs = j_decode.abstract_cache(j_cfg, s.global_batch, s.seq_len)
    shape_of = lambda tree, leaf: _flat(jax.tree.map(
        lambda x: tuple(x.shape) + (str(x.dtype).split(".")[-1],), tree,
        is_leaf=leaf))
    assert shape_of(t_abs, lambda x: isinstance(x, torch.Tensor)) == \
        shape_of(j_abs, None)


MESHES = {"2x2": (("data", "model"), (2, 2)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
TOKENS = [("dp", None, "model"), ("model", "dp"), ("dp", "model", "model"),
          (("pod", "data"), None), (None, "absent", "model"),
          (("data", "model"), "model"), ("pod", "dp"), ("dp",)]


def _j_maybe_shard(monkeypatch, names, tokens):
    """The PartitionSpec JAX's maybe_shard hands to
    ``with_sharding_constraint`` for these tokens on a mesh with these
    axis names."""
    seen = []
    monkeypatch.setattr(j_sh, "current_mesh",
                        lambda: SimpleNamespace(axis_names=names))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, p: seen.append(tuple(p)) or x)
    j_sh.maybe_shard(None, *tokens)
    return seen[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dp_override", (None, ("data", "model")))
def test_token_resolution_matches_jax(monkeypatch, mesh, dp_override):
    names, sizes = MESHES[mesh]
    t_mesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    j_mesh = SimpleNamespace(axis_names=names)
    try:
        j_sh.set_dp_axes(dp_override)
        t_sh.set_dp_axes(dp_override)
        assert t_sh.batch_axes(t_mesh) == j_sh.batch_axes(j_mesh)
        for tokens in TOKENS:
            assert _norm(t_sh.spec(*tokens, mesh=t_mesh)) == _norm(
                j_sh.spec(*tokens, mesh=j_mesh)), tokens
            assert _norm(t_sh.resolve(tokens, t_mesh)) == _norm(
                _j_maybe_shard(monkeypatch, names, tokens)), tokens
    finally:
        j_sh.set_dp_axes(None)
        t_sh.set_dp_axes(None)


def test_maybe_shard_places_on_a_fake_mesh(fake_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_mesh((2, 2), ("data", "model"))
    x = torch.zeros(4, 6, 8)
    with t_sh.use_mesh(mesh):
        y = t_sh.maybe_shard(x, "dp", None, "model")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 6, 4)
        # 'model' twice: the second dim drops it; a size-3 dim of a
        # 2-way axis would be uneven, so that axis is dropped.
        z = t_sh.maybe_shard(torch.zeros(4, 3), "model", "model")
        assert tuple(z.placements) == (Replicate(), Shard(0))
    assert t_sh.current_mesh() is None


def test_pod_major_placements_on_a_fake_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    p = t_sh.placements(t_sh.P(("pod", "data"), None), mesh)
    assert p == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        t_sh.placements(t_sh.P(("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        t_sh.placements(t_sh.P("model", "model"), mesh)


def test_without_a_mesh_maybe_shard_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert t_sh.current_mesh() is None
    assert t_sh.maybe_shard(x, "dp", "model") is x
    assert t_sh.replicated(lambda a: a * 2, x).equal(x * 2)


def test_one_device_axis_places_nothing(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_mesh((1, 2), ("data", "model"))
    assert t_sh.placements(t_sh.P("data", "model"), mesh) == (Replicate(),
                                                              Shard(1))


@pytest.mark.parametrize("arch", ("smollm-135m", "olmoe-1b-7b"))
def test_one_rank_mesh_step_equals_the_plain_step(arch):
    """A smoke train step and prefill with DTensor params, ZeRO-1 specs
    and the sharded regions live on a one-rank gloo mesh: every output
    bit-equal to the same step without a mesh (the card's phase 17c at
    smoke scale)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import forward, init_params
    from repro_torch.train import AdamWConfig, init_opt, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = smoke_config(get_arch(arch))
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    batch = synthetic_batches(cfg, 4, 32, seed=0, device="cpu")(0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    kw = dict(n_microbatches=2, remat="full")
    want = make_train_step(cfg, ocfg, **kw)(params, init_opt(params), batch)
    with torch.no_grad():
        h_want = forward(params, cfg, tokens=batch["tokens"])
    try:
        M._group("gloo", 1, dist.HashStore)
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        specs = t_model.build_param_specs(cfg, model_shards=1)
        zspecs = t_opt.zero_specs(specs, params, mesh)
        step = make_train_step(cfg, ocfg, param_specs=specs, zspecs=zspecs,
                               **kw)
        with t_sh.use_mesh(mesh):
            dp = t_sh.distribute_tree(params, specs, mesh)
            db = {k: t_sh.distribute(v, t_sh.P("dp", None), mesh)
                  for k, v in batch.items()}
            got = step(dp, t_opt.init_opt(dp, zspecs), db)
            with torch.no_grad():
                h_got = forward(dp, cfg, tokens=db["tokens"]).full_tensor()
    finally:
        M.teardown()
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    leaves = lambda out: (tree_leaves(out[0]) + [
        x for t in out[1][1:] for x in tree_leaves(t)] + [out[2]])
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(full(a), b)
    assert torch.equal(h_got, h_want)
