"""The port's mesh paths with real values on more than one rank.

On one rank every shard offset is 0 and a ``Partial`` placement is the
identity, so the explicit local regions (the MoE's dispatch and combine
at each device's expert and capacity offsets, the sLSTM on each
device's rows, the vocab lookup and the masked-sum cross entropy, the
decode's K/V row writes and its attention over a head- or
sequence-sharded cache, the argmax) are checked here on 2 and 4 ranks:
``torch.multiprocessing`` processes joined by a ``gloo`` group over a
``FileStore`` in the test's tmp dir (no network).  Each rank builds the
same f32 smoke params and inputs from a seed, runs them with no mesh
(the plain results, which the other ``test_torch_*`` files hold against
the JAX package) and then distributed on each mesh, and compares the
gathered results.  Tolerance: 1e-5 (f32; the sharded sums add in
another order), bf16's own for the bf16 K/V caches, and equal next
tokens wherever the plain logits' top two differ by more than 1e-4.
"""

from __future__ import annotations

import pytest
import torch

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _close(tag, got, want, **tol):
    torch.testing.assert_close(_full(got), want, msg=lambda m: f"{tag}: {m}",
                               **(tol or F32_TOL))


def _setup(arch):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import init_params
    cfg = smoke_config(get_arch(arch))
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    return cfg, params


def _model_shards(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index("model")] if "model" in names else 1


def _prefill(mesh, arch, tag):
    """The prefill forward: the MoE's routing, dispatch and combine
    (olmoe), the sLSTM and mLSTM blocks (xlstm), the vocab lookup."""
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import forward
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_param_specs
    cfg, params = _setup(arch)
    toks = synthetic_batches(cfg, 8, 32, seed=1, device="cpu")(0)["tokens"]
    with torch.no_grad():
        want = forward(params, cfg, tokens=toks)
        specs = build_param_specs(cfg, model_shards=_model_shards(mesh))
        with sh.use_mesh(mesh):
            got = forward(sh.distribute_tree(params, specs, mesh), cfg,
                          tokens=sh.distribute(toks, sh.P("dp", None), mesh))
    _close(f"{tag} prefill {arch}", got, want)


def _train(mesh, arch, tag):
    """One train step with ZeRO-1 specs and two microbatches (no remat:
    the remat modes are held to each other in ``test_torch_train.py``):
    the loss (the masked-sum target logit over the vocab shards) and the
    first moments (the gradients) and second moments."""
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_param_specs
    from repro_torch.train import AdamWConfig, init_opt, make_train_step
    from repro_torch.train import optimizer as opt
    cfg, params = _setup(arch)
    batch = synthetic_batches(cfg, 8, 32, seed=2, device="cpu")(0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    kw = dict(n_microbatches=2, remat="none")
    want = make_train_step(cfg, ocfg, **kw)(params, init_opt(params), batch)
    specs = build_param_specs(cfg, model_shards=_model_shards(mesh))
    zspecs = opt.zero_specs(specs, params, mesh)
    step = make_train_step(cfg, ocfg, param_specs=specs, zspecs=zspecs, **kw)
    with sh.use_mesh(mesh):
        got = step(sh.distribute_tree(params, specs, mesh),
                   opt.init_opt(sh.distribute_tree(params, specs, mesh),
                                zspecs),
                   {k: sh.distribute(v, sh.P("dp", None), mesh)
                    for k, v in batch.items()})
    _close(f"{tag} train {arch} loss", got[2], want[2])
    for name, g, w in (("m", got[1].m, want[1].m), ("v", got[1].v,
                                                    want[1].v)):
        for a, b in zip(opt.tree_leaves(g), opt.tree_leaves(w)):
            _close(f"{tag} train {arch} {name}", a, b, rtol=1e-4,
                   atol=1e-9 if name == "v" else 1e-7)


def _decode(mesh, arch, tag):
    """Three decode steps from lanes at positions that straddle the
    cache's sequence shards: the next tokens (the argmax over the
    gathered logits), the logits of the last step, and every cache."""
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_param_specs
    from repro_torch.serve import decode as dec
    cfg, params = _setup(arch)
    B, S = 4, 16
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    start = torch.tensor([5, 7, 8, 11])

    def run(p, cache, tokens):
        step = dec.make_serve_step(cfg)
        outs = []
        for _ in range(2):
            nxt, cache = step(p, cache, tokens)
            outs.append(nxt)
            tokens = sh.maybe_shard(_full(nxt)[:, None].long(), "dp", None)
        return outs, dec.decode_logits(p, cfg, cache, tokens), cache

    cache = dec.init_cache(cfg, B, S, device="cpu")
    cache["pos"].copy_(start)
    with torch.no_grad():
        w_toks, w_logits, w_cache = run(params, cache, toks)
        specs = build_param_specs(cfg, model_shards=_model_shards(mesh))
        cspecs = dec.cache_specs(cfg, B, S,
                                 model_shards=_model_shards(mesh))
        cache = dec.init_cache(cfg, B, S, device="cpu")
        cache["pos"].copy_(start)
        with sh.use_mesh(mesh):
            g_toks, g_logits, g_cache = run(
                sh.distribute_tree(params, specs, mesh),
                sh.distribute_tree(cache, cspecs, mesh),
                sh.distribute(toks, sh.P("dp", None), mesh))
    _close(f"{tag} decode {arch} logits", g_logits, w_logits)
    top2 = torch.topk(w_logits[:, -1, :cfg.vocab_size], 2).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert bool(clear.any()), f"{tag} decode {arch}: no clear argmax"
    for i, (a, b) in enumerate(zip(g_toks, w_toks)):
        assert torch.equal(_full(a)[clear], b[clear]), (
            f"{tag} decode {arch} step {i}: next tokens differ")
    flat = lambda t, pre="": ([(pre, t)] if not isinstance(t, dict) else [
        x for k, v in t.items() for x in flat(v, f"{pre}.{k}")])
    for (path, a), (_, b) in zip(flat(g_cache), flat(w_cache)):
        tol = {} if b.dtype == torch.float32 else dict(rtol=1.6e-2,
                                                        atol=1e-5)
        _close(f"{tag} decode {arch} cache {path}", a, b, **tol)


# Per world: (mesh shape, axis names, the checks run on it).  Together
# they take each region at a nonzero offset on some mesh dim: the MoE's
# experts over the model axis and its capacity over the data axes
# (pod-major on the three-axis mesh), the vocab over the model axis, the
# sLSTM's rows over the data axis, the decode's cache on its heads and
# on its sequence, and each region's gradient in a train step.
CHECKS = {
    2: [((1, 2), ("data", "model"),
         (("decode", "olmoe-1b-7b"), ("decode", "gemma-2b")))],
    4: [((2, 2), ("data", "model"),
         (("decode", "gemma-2b"), ("train", "olmoe-1b-7b"),
          ("train", "xlstm-350m"))),
        ((2, 2, 1), ("pod", "data", "model"),
         (("prefill", "olmoe-1b-7b"),))],
}


def _worker(rank: int, world: int, store_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    run = {"prefill": _prefill, "decode": _decode, "train": _train}
    try:
        for shape, names, checks in CHECKS[world]:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            tag = f"rank {rank} of mesh {dict(zip(names, shape))}"
            for what, arch in checks:
                run[what](mesh, arch, tag)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", sorted(CHECKS))
def test_mesh_paths_equal_the_plain_ones_on_several_ranks(world, tmp_path):
    import torch.multiprocessing as mp
    mp.start_processes(_worker, args=(world, str(tmp_path / "store")),
                       nprocs=world, join=True, start_method="spawn")
