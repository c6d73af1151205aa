"""Multi-pod dry run: prove the distribution config is coherent, as
``repro/launch/dryrun.py`` does, on fake devices.

For every (arch x shape) cell and each production mesh
(``launch/mesh.py``, fake ranks: this process is rank 0 of 256 or 512),
build fake stand-ins (``FakeTensorMode``: nothing is allocated) of the
params, the optimizer state, the cache and the inputs as DTensors with
the JAX package's specs (``build_param_specs``, ``zero_specs``,
``cache_specs``, batch over the data axes where they divide it), run the
step once under the op counter (``launch/op_cost.py``), and record the
per-device argument, output, temporary and peak bytes and the H100
roofline row (``launch/roofline.py``) to
``benchmarks/results/dryrun_torch_<arch>_<shape>_<mesh>.json``.

Peak bytes are the arguments' local shards plus the most bytes of live
storage the step's ops created at any one time (the counter's own
tracker); outputs are the results' local shards that are not arguments
(the decode step writes its cache in place: those bytes alias).

The cells ``cell_supported`` refuses are recorded ``skipped`` with its
reason; a cell that fails is recorded ``failed`` with its error, and
``main`` exits non-zero.

A train cell of a config with sLSTM blocks is fitted in T, not run at
its length: the sLSTM steps its tokens one at a time
(``models/xlstm.py::slstm_scan``), about 3 s a token on fake tensors on
the single-pod mesh, so xlstm-350m's ``train_4k`` would take hours.
Every layer's cost is a polynomial of degree at most 2 in T while the
mLSTM's chunk (256) divides T: linear in the sLSTM's steps and the
mLSTM's chunks, plus the op-granularity bytes of the eager backward,
where each of the T steps' ``select`` (and each chunk's ``slice``) of a
[B, T, ...] tensor gets a full-size gradient that is then accumulated.
So the cell runs at ``FIT_LENGTHS`` (same global batch, microbatches and
remat), each run in a process of its own, all at once, and each number
(memory, FLOPs, bytes, collectives, kernel calls) is the quadratic
through the three at the cell's T; the roofline row follows from those.
The record names the derived fields and the lengths under ``derived``.
``--check-fit T`` holds the fit against a full run at T.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--time-limit S]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m --shape train_4k --mesh single --check-fit 1024
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import time
import traceback
from fractions import Fraction

import torch

from repro_torch.configs.registry import (ARCHS, SHAPES, cell_supported,
                                          get_arch, get_shape, input_specs)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (_fake_mesh, make_production_mesh,
                                     teardown)
from repro_torch.launch.op_cost import CostReport, OpCounter
from repro_torch.models import sharding as sh
from repro_torch.models.model import (ModelConfig, abstract_params,
                                      active_param_count, build_param_specs,
                                      param_count)
from repro_torch.serve.decode import (abstract_cache, cache_specs,
                                      make_serve_step)
from repro_torch.train.optimizer import (AdamWConfig, OptState,
                                         make_train_step, tree_map,
                                         zero_specs)

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../benchmarks/results")
P = sh.P


def _dp_axes(mesh, batch: int):
    axes = tuple(a for a in ("pod", "data") if a in sh.axis_names(mesh))
    total = math.prod(sh.axis_size(mesh, a) for a in axes)
    return axes if (batch % total == 0 and batch >= total) else None


def _batch_specs(mesh, ins: dict, batch: int) -> dict:
    dp = _dp_axes(mesh, batch)
    return {k: P(dp, *([None] * (v.dim() - 1))) for k, v in ins.items()}


def build_train(cfg: ModelConfig, shape, mesh, device, *, n_micro=None,
                remat="full"):
    """(step, args, spec trees, meta) of the train cell: params, the
    ZeRO-1 optimizer state and the batch."""
    params = abstract_params(cfg, device=device)
    specs = build_param_specs(cfg, model_shards=sh.axis_size(mesh, "model"))
    zspecs = zero_specs(specs, params, mesh)
    f32 = lambda t: tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                                   device=device), t)
    opt = OptState(torch.empty((), dtype=torch.int32, device=device),
                   f32(params), f32(params), f32(params))
    opt_specs = OptState(P(), zspecs, zspecs, zspecs)
    ins = input_specs(cfg, shape, device=device)
    dp_total = math.prod(sh.axis_size(mesh, a) for a in sh.axis_names(mesh)
                         if a != "model")
    if n_micro is None:
        n_micro = max(1, shape.global_batch // dp_total)
    step = make_train_step(cfg, AdamWConfig(), n_microbatches=n_micro,
                           remat=remat, param_specs=specs, zspecs=zspecs)
    return (step, (params, opt, ins),
            (specs, opt_specs, _batch_specs(mesh, ins, shape.global_batch)),
            {"n_microbatches": n_micro, "remat": remat})


def build_prefill(cfg: ModelConfig, shape, mesh, device):
    from repro_torch.models.model import forward
    params = abstract_params(cfg, device=device)
    specs = build_param_specs(cfg, model_shards=sh.axis_size(mesh, "model"))
    ins = input_specs(cfg, shape, device=device)

    def fn(p, b):
        h = forward(p, cfg, tokens=b.get("tokens"), embeds=b.get("embeds"),
                    remat="none")
        table = p["embed"] if cfg.tie_embeddings else p["unembed"]
        return torch.einsum("bd,vd->bv", h[:, -1], table)

    return (fn, (params, ins),
            (specs, _batch_specs(mesh, ins, shape.global_batch)), {})


def build_decode(cfg: ModelConfig, shape, mesh, device):
    params = abstract_params(cfg, device=device)
    specs = build_param_specs(cfg, model_shards=sh.axis_size(mesh, "model"))
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len,
                           device=device)
    cspecs = cache_specs(cfg, shape.global_batch, shape.seq_len,
                         model_shards=sh.axis_size(mesh, "model"))
    dp = _dp_axes(mesh, shape.global_batch)
    # cache_specs puts ('pod', 'data') on the batch; the cell's dp there.
    fix = lambda s: P(*(dp if isinstance(x, tuple) and {"pod", "data"} & set(x)
                        else x for x in s))
    ins = input_specs(cfg, shape, device=device)
    step = make_serve_step(cfg)

    def fn(p, c, b):
        return step(p, c, tokens=b.get("tokens"), embeds=b.get("embeds"))

    return (fn, (params, cache, ins),
            (specs, tree_map(fix, cspecs),
             _batch_specs(mesh, ins, shape.global_batch)), {})


def _distribute(args, specs, mesh):
    """Each tensor of ``args`` as a DTensor with its spec (the trees are
    dicts and NamedTuples of tensors)."""
    if isinstance(args, torch.Tensor):
        return sh.distribute(args, specs, mesh)
    if isinstance(args, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in args.items()}
    parts = [_distribute(a, s, mesh) for a, s in zip(args, specs)]
    return type(args)(*parts) if hasattr(args, "_fields") else tuple(parts)


def _local_storages(tree) -> dict:
    """id(storage) -> bytes of every tensor's local shard in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


@contextlib.contextmanager
def fake_mode():
    """A ``FakeTensorMode`` in which DTensor works as it does eagerly.
    (1) It can find a shard's offsets: for a dim sharded over two mesh
    axes and then reshaped (``_StridedShard``), and for the global indices
    of an ``argmax`` over a sharded dim, DTensor computes them with a
    small ``arange`` read on the host, which an active fake mode would
    make a fake tensor with no values; those two functions run with the
    fake mode set aside.  (2) It keeps its caches: with a fake mode
    active DTensor takes itself to be tracing (symbolic shapes may vary)
    and propagates every op's sharding and plans every redistribution
    anew, which on a three-axis mesh costs minutes a layer; the dry run's
    shapes are concrete, so its sharding propagation and cost model are
    told they are not tracing."""
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)
    from torch.distributed.tensor import (_collective_utils, _redistribute,
                                          _sharding_prop, _utils,
                                          placement_types)

    def real(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return call

    def cached(fn):
        fn = functools.lru_cache(maxsize=None)(fn)
        return lambda *args, **kwargs: fn(*args, **kwargs)

    def not_tracing(fn):
        return lambda: False

    # Each patch where this torch has the function: their names move
    # between releases.
    strided = getattr(placement_types, "_StridedShard", None)
    wraps = [(_redistribute, "_gen_transform_infos_non_cached", cached),
             (strided, "local_shard_size_and_offset", real),
             (_utils, "_compute_local_shape_and_global_offset", real),
             (_sharding_prop, "_are_we_tracing", not_tracing),
             (_collective_utils, "_are_we_tracing", not_tracing)]
    sites = [(o, n, getattr(o, n), w) for o, n, w in wraps
             if o is not None and hasattr(o, n)]
    for o, n, fn, wrap in sites:
        setattr(o, n, wrap(fn))
    try:
        with FakeTensorMode() as mode:
            yield mode
    finally:
        for o, n, fn, _ in sites:
            setattr(o, n, fn)


def argument_bytes(builder, cfg, shape, mesh, device="cpu") -> int:
    """The per-device bytes of ``builder``'s step's arguments: their
    local shards as the dry run distributes them (the step not run)."""
    with fake_mode(), sh.use_mesh(mesh):
        _, args, specs, _ = builder(cfg, shape, mesh, device)
        return sum(_local_storages(_distribute(args, specs, mesh)).values())


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def run_step(builder, cfg, shape, mesh, device):
    """Run ``builder``'s step once on fake DTensors under the counter;
    returns (counter, memory record, meta)."""
    with fake_mode(), sh.use_mesh(mesh):
        fn, args, specs, meta = builder(cfg, shape, mesh, device)
        args = _distribute(args, specs, mesh)
        arg_st = _local_storages(args)
        with OpCounter() as counter:
            out = fn(*args)
        out_st = _local_storages(out)
    arg_b = sum(arg_st.values())
    out_b = sum(b for k, b in out_st.items() if k not in arg_st)
    alias_b = sum(b for k, b in out_st.items() if k in arg_st)
    peak = arg_b + counter.peak
    mem = dict(arg_bytes_per_dev=arg_b, out_bytes_per_dev=out_b,
               temp_bytes_per_dev=max(0, peak - arg_b - out_b),
               alias_bytes_per_dev=alias_b, peak_hbm_per_dev=peak)
    return counter, mem, meta


def _numbers(counter, mem) -> dict:
    """The numbers of one run of a step: its memory record and its
    counter's figures."""
    rep = counter.report()
    return dict(mem, coll_counts=rep.coll_counts,
                kernel_calls={k: v[0] for k, v in counter.by_op.items()
                              if k.startswith("ditto.")},
                flops_per_dev=rep.flops, bytes_per_dev=rep.bytes,
                fused_bytes_per_dev=rep.fused_bytes,
                coll_bytes_per_dev=rep.coll_bytes,
                coll_breakdown=rep.coll_breakdown)


# The lengths a fitted cell runs at (see the module docstring): evenly
# spaced, so the quadratic's weights at a multiple of the spacing are
# integers and integer fields stay exact.
FIT_LENGTHS = (256, 512, 768)


def fits_in_t(cfg: ModelConfig, shape, lengths=FIT_LENGTHS) -> bool:
    """Whether ``run_cell`` fits this cell in T at ``lengths`` (None: it
    never does): a train cell, longer than the lengths, of a config with
    sLSTM blocks."""
    kinds = set(cfg.block_pattern) | set(cfg.remainder)
    return (lengths is not None and shape.kind == "train"
            and "slstm" in kinds and shape.seq_len > max(lengths))


def _run_point(builder, cfg, shape, dims: dict, device_type: str):
    """(numbers, meta) of one run of ``builder``'s step at ``shape`` on a
    fake mesh ``dims`` (axis name -> size) of its own: the body of a
    fit's worker process."""
    try:
        mesh = _fake_mesh(tuple(dims.values()), tuple(dims), device_type)
        counter, mem, meta = run_step(builder, cfg, shape, mesh, device_type)
        return _numbers(counter, mem), meta
    finally:
        teardown()


def _run_points(builder, cfg, shape, mesh, device_type, lengths) -> list:
    """``_run_point`` at each of ``lengths``, each in a process of its
    own, all at once (a time limit's exception ends them)."""
    dims = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    jobs = [(builder, cfg, dataclasses.replace(shape, seq_len=t), dims,
             device_type) for t in lengths]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        return pool.starmap(_run_point, jobs)


def _fit(points: list, lengths, t: int):
    """The quadratic in T through ``points`` (nested dicts of numbers, one
    a length) at ``t``, number by number, in exact rationals: an int
    stays an int where the result is whole."""
    ws = [Fraction(math.prod(t - b for b in lengths if b != a),
                   math.prod(a - b for b in lengths if b != a))
          for a in lengths]

    def fit(vals):
        if isinstance(vals[0], dict):
            return {k: fit([v[k] for v in vals]) for k in vals[0]}
        x = sum(w * Fraction(v) for w, v in zip(ws, vals))
        whole = all(isinstance(v, int) for v in vals) and x.denominator == 1
        return int(x) if whole else float(x)

    return fit(points)


def _record(rec: dict, cfg, shape, n_dev: int, nums: dict, meta: dict,
            run_s: float) -> dict:
    """``rec`` completed as an ``ok`` cell from a step's numbers."""
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    n_active = active_param_count(cfg)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * d_tokens
    roof = rl.analyze(CostReport(
        nums["flops_per_dev"], nums["bytes_per_dev"],
        nums["fused_bytes_per_dev"], nums["coll_bytes_per_dev"],
        nums["coll_breakdown"], nums["coll_counts"]), n_dev, model_flops)
    rec.update(
        status="ok", run_s=round(run_s, 1), n_devices=n_dev,
        params=param_count(cfg), active_params=n_active,
        **{k: nums[k] for k in ("arg_bytes_per_dev", "out_bytes_per_dev",
                                "temp_bytes_per_dev", "alias_bytes_per_dev",
                                "peak_hbm_per_dev", "coll_counts",
                                "kernel_calls")},
        **meta, **roof.row())
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             save: bool = True, extra_tag: str = "", device_type: str = "cpu",
             step_override=None, fit_lengths=FIT_LENGTHS):
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, why = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=why)
        if save:
            _save(rec, extra_tag)
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device_type)
    builder = step_override or BUILDERS[shape.kind]
    t0 = time.time()
    derived = None
    if fits_in_t(cfg, shape, fit_lengths):
        pts = _run_points(builder, cfg, shape, mesh, device_type,
                          fit_lengths)
        nums = _fit([p for p, _ in pts], fit_lengths, shape.seq_len)
        meta = pts[0][1]
        derived = {"method": "quadratic in T through runs at seq_len",
                   "seq_len": list(fit_lengths),
                   "fields": [k for k in nums if k != "coll_breakdown"]}
    else:
        counter, mem, meta = run_step(builder, cfg, shape, mesh, device_type)
        nums = _numbers(counter, mem)
    _record(rec, cfg, shape, mesh.size(), nums, meta, time.time() - t0)
    if derived:
        rec["derived"] = derived
    if save:
        _save(rec, extra_tag)
    return rec


def check_fit(arch: str, shape_name: str, mesh_kind: str, at: int, *,
              device_type: str = "cpu", fit_lengths=FIT_LENGTHS) -> dict:
    """The fit held against a full run: the cell's numbers at T = ``at``
    derived from ``fit_lengths`` and run at ``at``, all in one pool.
    Returns {field: [derived, full, relative error]}, nested fields'
    names joined with '.'."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    shape = dataclasses.replace(shape, seq_len=at)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device_type)
    pts = _run_points(BUILDERS[shape.kind], cfg, shape, mesh, device_type,
                      (*fit_lengths, at))
    got = _fit([p for p, _ in pts[:-1]], fit_lengths, at)
    out = {}

    def walk(name, a, b):
        if isinstance(a, dict):
            for k in a:
                walk(f"{name}.{k}", a[k], b[k])
        else:
            out[name] = [a, b, abs(a - b) / abs(b) if b else float(a != b)]

    for k in got:
        walk(k, got[k], pts[-1][0][k])
    return out


def _save(rec, extra_tag=""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = f"_{extra_tag}" if extra_tag else ""
    path = os.path.join(
        RESULTS_DIR,
        f"dryrun_torch_{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


class CellTimeout(Exception):
    """A cell ran past ``run_cells``' time limit."""


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise :class:`CellTimeout` in this (main) thread after ``seconds``
    (0: no limit)."""
    if not seconds:
        yield
        return
    import signal

    def fire(*_):
        raise CellTimeout(f"did not finish in {seconds} s")

    prev = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def run_cells(cells, meshes, *, device_type: str = "cpu", save: bool = True,
              log=print, time_limit: int = 0) -> list:
    """Run each (arch, shape) on each mesh kind; a failure, or a cell that
    runs past ``time_limit`` seconds (0: none), is recorded ``failed``
    with its error, never skipped.  Returns the records."""
    recs = []
    for arch, shape in cells:
        for mk in meshes:
            try:
                with _time_limit(time_limit):
                    rec = run_cell(arch, shape, mk, save=save,
                                   device_type=device_type)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "failed",
                       "error": f"{type(e).__name__}: {e}"}
                if save:
                    _save(rec)
                log(f"[FAIL] {arch} x {shape} x {mk}: {rec['error']}")
                traceback.print_exc()
            else:
                if rec["status"] == "ok":
                    log(f"[OK] {arch} x {shape} x {mk}: run={rec['run_s']}s "
                        f"hbm/dev={rec['peak_hbm_per_dev'] / 2**30:.2f}GiB "
                        f"bottleneck={rec['bottleneck']} "
                        f"t=({rec['t_compute_s']:.2e},"
                        f"{rec['t_memory_fused_s']:.2e},"
                        f"{rec['t_collective_s']:.2e})s")
                else:
                    log(f"[SKIP] {arch} x {shape} x {mk}: {rec['reason']}")
            recs.append(rec)
    return recs


def table(results_dir: str = RESULTS_DIR) -> str:
    """The saved records as a markdown table: a row per arch, a column
    per shape, each cell the single-pod and the multi-pod mesh's
    per-device peak (GiB), FLOPs, bottleneck (C compute, M memory, X
    collective) and step bound (s), or the record's status."""
    recs = {}
    for f in sorted(os.listdir(results_dir)):
        if f.startswith("dryrun_torch_") and f.endswith(".json"):
            with open(os.path.join(results_dir, f)) as fh:
                r = json.load(fh)
            recs[(r["arch"], r["shape"], r["mesh"])] = r

    def cell(r):
        if r is None:
            return "not run"
        if r["status"] != "ok":
            return r["status"]
        bound = max(r["t_compute_s"], r["t_memory_fused_s"],
                    r["t_collective_s"])
        letter = {"compute": "C", "memory": "M", "collective": "X"}
        return (f"{r['peak_hbm_per_dev'] / 2**30:.1f} / "
                f"{r['flops_per_dev']:.2g} / {letter[r['bottleneck']]} / "
                f"{bound:.2g}")

    rows = ["| Arch | " + " | ".join(SHAPES) + " |",
            "|---" * (len(SHAPES) + 1) + "|"]
    for arch in ARCHS:
        rows.append(f"| {arch} | " + " | ".join(
            f"{cell(recs.get((arch, s, 'single')))}; "
            f"{cell(recs.get((arch, s, 'multi')))}" for s in SHAPES) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records as a markdown table")
    ap.add_argument("--time-limit", type=int, default=0,
                    help="record a cell that runs longer than this many "
                         "seconds as failed (default: no limit)")
    ap.add_argument("--check-fit", type=int, metavar="T",
                    help="hold the fit of a cell fitted in T against a "
                         "full run at length T (one mesh); print each "
                         "field's relative error")
    args = ap.parse_args(argv)
    if args.table:
        print(table())
        return
    if args.check_fit:
        if not (args.arch and args.shape) or args.mesh == "both":
            ap.error("--check-fit takes --arch, --shape and one --mesh")
        t0 = time.time()
        try:
            errs = check_fit(args.arch, args.shape, args.mesh, args.check_fit)
        finally:
            teardown()
        for k, (got, want, err) in errs.items():
            print(f"{k:36s} {got:>22} {want:>22} {err:.3e}")
        worst = max(errs, key=lambda k: errs[k][2])
        print(json.dumps({"arch": args.arch, "shape": args.shape,
                          "mesh": args.mesh, "at": args.check_fit,
                          "fit_lengths": list(FIT_LENGTHS),
                          "run_s": round(time.time() - t0, 1),
                          "worst": worst, "fields": errs}))
        return

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cells = ([(a, s) for a in ARCHS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    try:
        recs = run_cells(cells, meshes, time_limit=args.time_limit)
    finally:
        teardown()
    failures = sum(r["status"] == "failed" for r in recs)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
