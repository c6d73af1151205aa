"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

* For every arch x shape x production mesh, the per-device argument
  bytes of the port's distributed stand-ins (params, ZeRO-1 optimizer
  state, cache, inputs) equal the bytes JAX's specs and abstract trees
  give, with nothing compiled;
* a smoke train cell on a (data=2, model=2) mesh: the port's argument
  bytes equal JAX's ``memory_analysis().argument_size_in_bytes`` of the
  same cell, compiled in a 4-device subprocess;
* the ``long_500k`` skips are JAX's, and a whole smoke cell runs to
  ``ok`` with its roofline row;
* the cross entropy's live bytes on a (pod, data, model) mesh equal
  those on a (data, model) mesh with the same rows a device (the pod
  axis folds into the data axes, nothing is gathered over it);
* a train cell with sLSTM blocks, fitted in T from three shorter runs,
  equals a full run at its length within 1% in every derived field.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

from repro.configs import registry as j_reg
from repro.models import model as j_model
from repro.serve import decode as j_decode
from repro.train import optimizer as j_opt
from repro_torch.configs import registry as t_reg
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def production_meshes():
    """Both production meshes over fake ranks (made in turn: one default
    process group at a time); destroyed after the module."""
    from repro_torch.launch import mesh as M
    yield lambda kind: M.make_production_mesh(multi_pod=kind == "multi")
    M.teardown()


def _local_bytes(leaf, spec, sizes) -> int:
    n = math.prod(leaf.shape) * leaf.dtype.itemsize
    for entry in tuple(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in sizes:
                n //= sizes[a]
    return n


def _tree_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(x, s, sizes) for x, s in zip(leaves, spec_leaves))


def _jax_argument_bytes(arch, shape_name, kind) -> int:
    """Per-device argument bytes from the JAX package's specs and
    abstract trees, as its dry run lays the cell out."""
    from jax.sharding import PartitionSpec as P
    sizes = MESHES[kind]
    cfg, shape = j_reg.get_arch(arch), j_reg.get_shape(shape_name)
    params = j_model.abstract_params(cfg)
    specs = j_model.build_param_specs(cfg, model_shards=16)
    total = _tree_bytes(params, specs, sizes)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp_total = math.prod(sizes[a] for a in dp_axes)
    b = shape.global_batch
    dp = dp_axes if (b % dp_total == 0 and b >= dp_total) else None
    for x in j_reg.input_specs(arch, shape_name).values():
        total += _local_bytes(x, P(dp, *([None] * (len(x.shape) - 1))),
                              sizes)
    if shape.kind == "train":
        mesh = SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
        z = j_opt.zero_specs(specs, params, mesh)
        total += 4 + 3 * _tree_bytes(
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, "float32"),
                         params), z, sizes)
    elif shape.kind == "decode":
        cache = j_decode.abstract_cache(cfg, b, shape.seq_len)
        cspecs = j_decode.cache_specs(cfg, b, shape.seq_len, 16)
        fix = lambda s: P(*(dp if isinstance(x, tuple)
                            and {"pod", "data"} & set(x) else x for x in s))
        total += _tree_bytes(cache, jax.tree.map(
            fix, cspecs, is_leaf=lambda x: isinstance(x, P)), sizes)
    return total


CELLS = [(a, s, m) for a in t_reg.ARCHS for s in t_reg.SHAPES
         for m in MESHES]


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_argument_bytes_match_jax_specs(production_meshes, kind):
    mesh = production_meshes(kind)
    for arch, shape_name, m in CELLS:
        if m != kind:
            continue
        cfg, shape = t_reg.get_arch(arch), t_reg.get_shape(shape_name)
        ok, why = t_reg.cell_supported(cfg, shape)
        assert (ok, why) == j_reg.cell_supported(j_reg.get_arch(arch),
                                                 j_reg.get_shape(shape_name))
        if not ok:
            continue
        got = dryrun.argument_bytes(dryrun.BUILDERS[shape.kind], cfg, shape,
                                    mesh)
        assert got == _jax_argument_bytes(arch, shape_name, kind), \
            (arch, shape_name, kind)


def test_long_500k_skips_match_jax():
    rec = dryrun.run_cell("yi-9b", "long_500k", "single", save=False)
    assert rec["status"] == "skipped"
    skipped = {a for a in t_reg.ARCHS if not t_reg.cell_supported(
        t_reg.get_arch(a), t_reg.get_shape("long_500k"))[0]}
    j_skipped = {a for a in j_reg.ARCHS if not j_reg.cell_supported(
        j_reg.get_arch(a), j_reg.get_shape("long_500k"))[0]}
    assert skipped == j_skipped and "recurrentgemma-2b" not in skipped


SMOKE_SHAPE = dict(seq_len=32, global_batch=8)

_JAX_SMOKE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, jax
from repro.configs import registry as R
from repro.launch import dryrun as D
cfg = R.smoke_config(R.get_arch("smollm-135m"))
shape = dataclasses.replace(R.get_shape("train_4k"), **%r)
D.get_arch = lambda name: cfg
D.get_shape = lambda name: shape
D.input_specs = lambda arch, name, **kw: {
    k: jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len), "int32")
    for k in ("tokens", "labels")}
from repro.launch.mesh import _make_mesh
D.make_production_mesh = lambda multi_pod=False: _make_mesh(
    (2, 2), ("data", "model"))
rec = D.run_cell("smollm-135m", "train_4k", "single", save=False)
print("ARG_BYTES", json.dumps(rec["arg_bytes_per_dev"]))
""" % (SMOKE_SHAPE,)


def test_smoke_train_cell_matches_jax_memory_analysis(monkeypatch):
    out = subprocess.run([sys.executable, "-c", _JAX_SMOKE],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src",
                                  JAX_PLATFORMS="cpu"), timeout=600)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("ARG_BYTES")]
    assert line, out.stdout[-2000:] + out.stderr[-4000:]
    want = json.loads(line[0].split(" ", 1)[1])

    from repro_torch.launch import mesh as M
    cfg = t_reg.smoke_config(t_reg.get_arch("smollm-135m"))
    shape = dataclasses.replace(t_reg.get_shape("train_4k"), **SMOKE_SHAPE)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: cfg)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: shape)
    try:
        mesh = M.make_host_mesh(model=2, data=2)
        monkeypatch.setattr(dryrun, "make_production_mesh",
                            lambda **kw: mesh)
        rec = dryrun.run_cell("smollm-135m", "train_4k", "single",
                              save=False)
    finally:
        M.teardown()
    assert rec["status"] == "ok"
    assert rec["arg_bytes_per_dev"] == want
    # The step ran: a roofline row with the counter's figures.
    assert rec["flops_per_dev"] > 0 and rec["coll_bytes_per_dev"] > 0
    assert rec["peak_hbm_per_dev"] >= rec["arg_bytes_per_dev"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_xent_peak_on_a_pod_mesh_equals_the_data_mesh():
    """The train loss's cross entropy and its gradient, with a
    microbatch's labels, on fake (data=8, model=2) and (pod=2, data=4,
    model=2) meshes: the same rows and vocab columns a device, so the same
    peak of live bytes under the counter.  (A target logit taken through
    a [B, T, V] mask broadcast against labels sharded over two mesh axes
    gathered the rows over the data axis in the backward: the multi-pod
    train cells' peaks were 1.2-3.9x the single-pod ones.)"""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import sharding as sh
    from repro_torch.models.layers import logits_and_xent
    from repro_torch.train.optimizer import _microbatches
    B, T, d, V = 16, 64, 32, 4096
    peaks = []
    for shape, names in (((8, 2), ("data", "model")),
                         ((2, 4, 2), ("pod", "data", "model"))):
        dp = tuple(n for n in names if n != "model")
        try:
            mesh = M._fake_mesh(shape, names, "cpu")
            with dryrun.fake_mode(), sh.use_mesh(mesh):
                x = sh.distribute(torch.empty(B, T, d), sh.P(dp, None, None),
                                  mesh).requires_grad_()
                table = sh.distribute(torch.empty(V, d), sh.P("model", None),
                                      mesh).requires_grad_()
                labels = _microbatches(sh.distribute(
                    torch.empty(2 * B, T, dtype=torch.int64),
                    sh.P(dp, None), mesh), 2)[0]
                with OpCounter() as c:
                    loss = logits_and_xent(x, table, labels)
                    torch.autograd.grad(loss, [x, table])
        finally:
            M.teardown()
        peaks.append(c.peak)
    assert peaks[0] == peaks[1], peaks


def test_only_slstm_train_cells_are_fitted_in_t():
    """The fit is chosen by block kind: xlstm-350m's train cell (under any
    name), no other arch's, and none of its other shapes."""
    train = t_reg.get_shape("train_4k")
    fitted = {a for a in t_reg.ARCHS
              if dryrun.fits_in_t(t_reg.get_arch(a), train)}
    assert fitted == {"xlstm-350m"}
    cfg = dataclasses.replace(t_reg.get_arch("xlstm-350m"), name="renamed")
    assert dryrun.fits_in_t(cfg, train)
    assert not dryrun.fits_in_t(cfg, train, None)
    assert not any(dryrun.fits_in_t(cfg, t_reg.get_shape(s))
                   for s in t_reg.SHAPES if s != "train_4k")


FIT_SHAPE = dict(seq_len=64, global_batch=2)
FIT_LENGTHS = (16, 32, 48)


def test_slstm_train_cell_fitted_in_t_equals_a_full_run(monkeypatch):
    """xlstm-350m's smoke config (an sLSTM block among mLSTM ones) as a
    train cell at T = 64 on a (data=2, model=2) mesh: fitted from runs at
    T = 16, 32 and 48 in worker processes, every derived field and the
    roofline row within 1% of a full run at T = 64 (one mLSTM chunk at
    every length here, as the production fit's lengths are all multiples
    of the chunk)."""
    from repro_torch.launch import mesh as M
    cfg = t_reg.smoke_config(t_reg.get_arch("xlstm-350m"))
    assert "slstm" in cfg.block_pattern
    shape = dataclasses.replace(t_reg.get_shape("train_4k"), **FIT_SHAPE)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: cfg)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: shape)
    try:
        mesh = M.make_host_mesh(model=2, data=2)
        monkeypatch.setattr(dryrun, "make_production_mesh",
                            lambda **kw: mesh)
        fit = dryrun.run_cell("xlstm-350m", "train_4k", "single",
                              save=False, fit_lengths=FIT_LENGTHS)
        full = dryrun.run_cell("xlstm-350m", "train_4k", "single",
                               save=False, fit_lengths=None)
    finally:
        M.teardown()
    assert fit["status"] == full["status"] == "ok" and "derived" not in full
    assert fit["derived"]["seq_len"] == list(FIT_LENGTHS)
    assert set(fit) - {"derived", "run_s"} == set(full) - {"run_s"}
    fields = fit["derived"]["fields"]
    assert {"peak_hbm_per_dev", "flops_per_dev", "bytes_per_dev",
            "coll_counts"} <= set(fields)
    assert fit["flops_per_dev"] > 0 and fit["coll_bytes_per_dev"] > 0

    def close(a, b, what):
        if isinstance(a, dict):
            for k in a:
                close(a[k], b[k], f"{what}.{k}")
        elif not isinstance(a, str):
            assert abs(a - b) <= 0.01 * abs(b), (what, a, b)
        else:
            assert a == b, what

    for k in set(full) - {"run_s", "arch", "shape", "mesh", "status"}:
        close(fit[k], full[k], k)
