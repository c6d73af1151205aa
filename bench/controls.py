"""The readings the check's limits are set from, at a cell's own size:

    python3 bench/controls.py --workload <name> --seeds 1,2,3 [--calls N]

For each seed it sets the cell up as a run does (the program, its
traffic, the load phase, the warm calls), runs the next ``N`` calls of
the stream (by default as many as a run's checked run of calls), keeps
the state before and after them, and then reads every number the check
compares for:

* ``sound``: the program against the reference, as a run does;
* ``control``: the reference put in the program's place with one
  guarantee of the configuration broken: a hit's metadata (its slot's
  last access and extension) is not written back, the shortcut a faster
  step would be tempted by;
* the faults a cell can have, planted in the reference put in the
  program's place: ``state_unchanged`` (each step returns the state it
  was given), ``half_batch`` (half of the lanes' requests left out),
  ``answer_altered`` (one hit flag flipped where it is produced),
  ``occupancy_stale`` (each step leaves the pool's object and byte counts
  as they were: seen where the pool's occupancy moves),
  ``evictions_uncounted`` (the object count leaves out the step's
  evictions: seen where the pool evicts), ``bucket_misplaced`` (one key
  in eight probed and inserted in a neighbouring bucket: seen where no
  insert or eviction is),
  ``plan_unchecked`` (the planner packs ``batch`` rows a group whatever
  they touch), ``plan_reordered`` (the planner's groups with their rows
  in reverse order; reads alone never cut a group, so only a reordering
  shows in a read-only cell's plan) and, on the DM cells,
  ``exchange_left_out`` (every request served by its own source shard).

It prints one JSON line per (seed, variant), then a summary: for each
number, the largest sound reading and the smallest reading of each other
variant.  The benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

VARIANTS = ("sound", "control", "state_unchanged", "half_batch",
            "answer_altered", "occupancy_stale", "evictions_uncounted",
            "bucket_misplaced", "plan_unchecked", "plan_reordered",
            "exchange_left_out")


@contextlib.contextmanager
def planted(variant: str):
    """The reference with ``variant``'s fault in it, for the block."""
    import numpy as np
    import torch

    from bench.kinds import pool as kpool
    from bench.reference import cache as ref
    from bench.reference import dm as ref_dm
    saved = [(ref, "step", ref.step), (kpool, "pack_rows", kpool.pack_rows),
             (ref_dm, "route", ref_dm.route),
             (ref, "write_rows", ref.write_rows),
             (ref, "hash_key", ref.hash_key)]
    real_hash = ref.hash_key
    real_step, real_pack, real_route = ref.step, kpool.pack_rows, ref_dm.route
    real_write = ref.write_rows
    flipped = []

    def step(cfg, st, cl, stats, keys, *a, **kw):
        if variant == "half_batch":
            keys = keys.clone()
            keys[:, keys.shape[1] // 2:] = 0
        if variant == "state_unchanged":
            cols = {f: st[f].clone() for f in ref.SLOT_COLUMNS}
            sc, _, _, hit = real_step(cfg, st, cl, stats, keys, *a, **kw)
            for f, v in cols.items():
                st[f].copy_(v)
            return {f: st[f] for f in sc}, cl, stats, hit
        sc, cl2, stats2, hit = real_step(cfg, st, cl, stats, keys, *a, **kw)
        if variant == "occupancy_stale":
            sc = dict(sc, n_cached=st["n_cached"],
                      bytes_cached=st["bytes_cached"])
        if variant == "evictions_uncounted":
            sc = dict(sc, n_cached=sc["n_cached"] + stats2["evictions"]
                      - stats["evictions"])
        live = (keys != 0).reshape(-1).nonzero()
        if variant == "answer_altered" and not flipped and len(live):
            # The first real request's answer (a padded lane's reaches
            # no client).
            hit = hit.clone().reshape(-1)
            hit[live[0, 0]] = ~hit[live[0, 0]]
            hit = hit.reshape(keys.shape)
            flipped.append(True)
        return sc, cl2, stats2, hit

    def pack_rows(keys, n_buckets, batch, is_write):
        if variant == "plan_reordered":
            gk, gw, gt = real_pack(keys, n_buckets, batch, is_write)
            rows = (gt >= 0).any(axis=2).sum(axis=1)
            for g, n in enumerate(rows):
                for a in (gk, gw, gt):
                    a[g, :n] = a[g, :n][::-1].copy()
            return gk, gw, gt
        if variant != "plan_unchecked":
            return real_pack(keys, n_buckets, batch, is_write)
        T, C = keys.shape
        ng = -(-T // batch)
        gk = np.zeros((ng * batch, C), np.uint32)
        gw = np.zeros((ng * batch, C), bool)
        gt = np.full((ng * batch, C), -1, np.int32)
        gk[:T], gw[:T] = keys, is_write
        gt[:T] = np.where(keys != 0, np.arange(T, dtype=np.int32)[:, None],
                          -1)
        return (gk.reshape(ng, batch, C), gw.reshape(ng, batch, C),
                gt.reshape(ng, batch, C))

    def route(keys, is_write, n_shards, lanes, q, n_buckets):
        if variant != "exchange_left_out":
            return real_route(keys, is_write, n_shards, lanes, q, n_buckets)
        # No exchange: each source shard serves its own lanes' requests.
        NG, G, _ = keys.shape
        S = n_shards
        rk = np.zeros((NG, S, G, S * q), np.int64)
        rw = np.zeros((NG, S, G, S * q), bool)
        src = np.full((NG, S, G, S * q), -1, np.int64)
        drops = np.zeros(S, np.int64)
        for n in range(NG):
            for g in range(G):
                for s in range(S):
                    used = 0
                    for lane in range(lanes):
                        i = s * lanes + lane
                        if keys[n, g, i] == 0:
                            continue
                        if used >= q:
                            drops[s] += 1
                            continue
                        at = s * q + used
                        used += 1
                        rk[n, s, g, at] = keys[n, g, i]
                        rw[n, s, g, at] = is_write[n, g, i]
                        src[n, s, g, at] = i
        return rk, rw, src, drops

    def write_rows(idx, cols, srcs, mask=None):
        # The hit metadata's write is the one of (last access, extension).
        if variant == "control" and len(cols) == 2 \
                and cols[1].is_floating_point():
            return
        real_write(idx, cols, srcs, mask)

    def hash_key(key):
        h = real_hash(key)
        if variant == "bucket_misplaced":
            h = torch.where(key % 8 == 0, h ^ 1, h)
        return h

    ref.step, kpool.pack_rows, ref_dm.route = step, pack_rows, route
    ref.write_rows, ref.hash_key = write_rows, hash_key
    try:
        with torch.no_grad():
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def readings(cell: dict, seed: int, n_calls: int, device: str,
             variants=VARIANTS) -> dict:
    """{variant: {number: reading}} over the ``n_calls`` consecutive calls
    after the cell's set-up, from seed ``seed``, each variant run from the
    program's state before the first."""
    import importlib

    import torch

    from bench.harness import check
    from bench.harness.cell import setup

    config = cell["config"]
    kind = importlib.import_module(f"bench.kinds.{config['kind']}")
    stream, prog, snaps, _ = setup(cell, seed, torch.device(device), 3)
    before, calls, got_outs = snaps.take(prog.leaves()), [], []
    for _ in range(n_calls):
        keys, wr = stream.next()
        calls.append((keys, wr))
        got_outs.append(prog.call(keys, wr, keep=True)["out"])
    got_after = snaps.take(prog.leaves())
    prog.release()
    del prog
    cache = config["cache"]
    want_after, want_outs = kind.reference_calls(config, before, calls,
                                                 device)
    # A DM cell has no planner; only a DM cell has an exchange.
    skip = ({"plan_unchecked", "plan_reordered"} if config["kind"] == "dm"
            else {"exchange_left_out"})
    out = {}
    for variant in variants:
        if variant in skip:
            continue
        tally = check.new_tally()
        if variant == "sound":
            after, outs = got_after, got_outs
        else:
            with planted(variant):
                after, outs = kind.reference_calls(config, before, calls,
                                                   device)
            tally["invariants"] += check.invariants(
                {k: v.to(device) for k, v in after.items()},
                cache["n_buckets"], cache["assoc"], kind.n_shards(config))
        check.merge(tally, check.compare_state(after, want_after))
        for got, want in zip(outs, want_outs):
            check.merge(tally, kind.compare_outputs(got, want))
        del after
        out[variant] = dict(tally, **check.compared(tally))
    return out


def summary(rows: list) -> dict:
    """For each number: the largest sound reading, and each other
    variant's smallest."""
    out = {}
    for row in rows:
        for variant, tally in row["readings"].items():
            for k, v in tally.items():
                cur = out.setdefault(k, {}).get(variant)
                pick = max if variant == "sound" else min
                out[k][variant] = v if cur is None else pick(cur, v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, of: " + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    from bench.harness import spec
    cell = spec.load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = dict(workload=args.workload, seed=seed,
                   readings=readings(cell, seed, args.calls
                                     or int(cell["config"]["check"]["calls"]),
                                     args.device,
                                     args.variants.split(",")))
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(workload=args.workload, summary=summary(rows))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
