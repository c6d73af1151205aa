#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                     # the full run (one card)
    python3 chip_smoke.py --profile 200 --out runs/smoke.json
                                              # + traced windows, saved
    python3 chip_smoke.py --step-only --profile 20
                                              # the step's operators and
                                              # trace alone (no result)
    python3 chip_smoke.py --dm-only           # phase 11 cold and warm
    python3 chip_smoke.py --ranks-only        # phases 11-13, then 18

``--requests N`` shortens the end-to-end phase; below ~4.5M requests
the table does not fill, and the run fails its eviction check.
``--step-only`` plans phase 3's trace, counts one eager step's operators
per backend and, with ``--profile``, traces the steps, and stops: it
needs only ``execute``, ``make`` and ``access_group_``, so it also runs
from an older checkout's ``src/`` (the before of a change to the step).
``--dm-only`` runs phase 11's fused YCSB-A twice in a fresh process
(the first run captures the DM step's graph) with the capture's time,
the host's time in the replays and the device time of every 512
replays, and stops; it also runs from an older checkout's ``src/``.
``--ranks-only`` runs phases 11, 12 and 13, which phase 18 is held to,
then phase 18, and stops.

Phases, each of which raises (exit code != 0) on any failure:

1. Build: the hand-written CUDA kernels of ``src/repro_torch/kernels/csrc``
   compile with nvcc (one process per source, all at once).  Then the
   float sums that follow XLA's CPU order (``core/cache.py``'s
   ``_seqsum``, ``_xla_sum0``, the sum and scan over E, ``_expert_cdf``,
   ``apply_penalties``' normalisation and the drain's tenant mean) on
   the card against a host f32 loop, at 1 to 128 rows, E = 1 to 8, with
   no, one and three columns: every output bit-equal.
2. Per-kernel check: the cache step's four kernels, ``access_probe``
   (alone, and with the insert path's bucket facts: every expert
   choice's bucket argmin, E included), ``hit_metadata_update`` (in
   place, and its functional form), ``ranked_eviction`` (samples of
   K = 5, and K = 33 and 64, wider than a warp) and ``drop_scatter`` (the
   apply's three write groups in one launch: SET, masked inserts of nine
   columns, masked evictions of B * K entries with select sources,
   collisions across the groups), against their plain PyTorch versions
   on the card, over a random 2,097,152-slot table made with numpy from
   a seed, at B = 64 and B = 2048 with duplicates, -1 no-ops, every hit
   on one slot, flushes on exactly the hit slots, history ages that
   wrap, quota > 1 and tenant filters.  ``ranked_eviction``'s draw form
   (the cache step's: each op's threefry draw, expert choice and victim
   bitmaps in the kernel) at B = 1, 63 and 2048, K = 5, 33 and 64, E = 1,
   2 and 5, with lanes whose cdf stays below every draw (choice E, no
   victim), a scalar or a per-op quota and timestamps that wrap past
   2^32; and its tenant case (the multi-tenant step's): a tenant column
   over 4 tenants, a filter of -1 and tenant ids, each op's tenant
   picking its row of a [64, 4, E] cdf, W = 128, K = 5, 33 and 64, B =
   1, 63 and 2048, each filtered op's victims of its own tenant.  Every
   output must be bit-equal.
   An empty kernel is timed first, the launch floor.  Each kernel and
   its plain version are timed with CUDA events at the main path's
   shapes (the in-place ones on copies of the columns, with no copy in
   the time; ``ranked_eviction`` in its draw form); the probe alone, the
   insert group alone, ``ranked_eviction`` given the draw's offsets and
   choices, its tenant case at phase 9's shape (W = 128, beside the
   untenanted draw at W = 128), and ``hit_metadata_update``'s functional
   form, which copies the three columns first, on their own.
   Then the three kernels that only the ``kernels.ops`` entry point
   reaches: ``bucket_lookup``, ``sampled_eviction`` (f32 columns padded
   at the tail by W = 20, 128 and 132 with empty slots, K = 5, 33 and
   64, all five experts, the clock as a number and on the card, a window
   wholly in the empty tail) and ``metadata_update`` (f32 freq and last_ts; duplicate, -1
   and past-the-table slots; non-integer deltas) against their plain
   versions at B = 13, 64 and 2048: integers and both f32 columns
   bit-equal, and two ``metadata_update`` launches the same bits.
   ``bucket_lookup`` at assoc 1, 4, 6, 8, 16 and 64 on tables with a
   ragged tail (C not a multiple of assoc) at B = 1, 63 and 2048, and
   ``metadata_update`` in six cases (one slot, every slot twice B / 2
   apart, distinct slots of one tile, both sides of the tile edges, -1 and
   past-C no-ops, mixed) at B = 1, 63, 2048 and 65,536, on the table and
   on one 5 slots shorter, with a NaN in last_ts: into fresh outputs, in
   place and a second time; bit-equal, one launch a call.  The
   entry point's path, counted: 8 Get batches of 2048 keys, each
   probed with ``bucket_lookup_op``, its hits' freq and last_ts updated
   with ``metadata_update_op`` at the batch's clock, and a victim
   sampled for every op with ``sampled_eviction_op`` from the updated
   columns; the same batches through the plain versions must give the
   same bits.  Each of the three is timed at B = 2048
   (``metadata_update`` in place, and its functional form, whose launch
   also copies the two columns, beside PyTorch's copy of them), and
   ``metadata_update`` in place on the pairs, one slot and one tile, and
   at B = 65,536.
3. End to end, grouped: YCSB-A (50% SET, zipf 0.99) over 10M keys, 64
   client lanes, a 2,097,152-slot cache (capacity 1,048,576 objects),
   planned once at batch 32, through ``execute()`` with the fused and
   the reference backend.  Integer state, OpStats and per-round hits
   must be bit-equal, f32 columns within 4 ulp; every kernel must have
   launched, each as often as the others (once a step: the probe with
   its facts, and one ``drop_scatter`` for the apply's three write
   groups), and the cache must have evicted.  One eager grouped step of
   each backend runs under a dispatch mode that counts its operators
   (and the bitwise ops and shifts among them) and lists every one
   returning a whole column (2,097,152 rows or more): the fused step's
   must be the ``bytes_cached`` reduction's two and nothing else (no
   clone, copy, concatenation or fill of a column; its kernels write the
   table in place), and it must call no ``core.prng`` function (its
   threefry draw is in the eviction kernel).
4. End to end, sequential: 1,000 more rounds at ``plan=None`` from the
   warmed caches, checked the same way.
5. End to end, adaptive: 2,000 more rounds through ``execute()`` with
   its default plan (``"adaptive"``, a width per 64-row window), from
   the caches phase 4 left, checked the same way.
6. Flash kernel: ``flash_attention`` against its plain version on the
   card at yi-9b's (B=1, T=4096, H=32, D=128), smollm-135m's (B=4,
   T=2048, H=9, D=64) and gemma-2b's (B=1, T=4096, H=8, Hkv=1, D=256)
   attention shapes in bf16 and f32, with k and v as ``repeat_kv``'s GQA
   expand view, at a ragged T = 1000, and once with plain [B, T, H, D] k
   and v.  Every output row (b, t, h) must be within a relative L2 error
   of 2^-7 in bf16 and 2^-16 in f32 of the plain version's f32 output
   (about twice the largest reading on the card), and every element
   within 2e-2 in bf16 and 2e-5 in f32 of the plain version's output (as
   ``tests/test_kernels.py`` holds the Pallas kernel).  Controls on
   yi-9b's bf16 inputs show the row bound's two sides: the kernel's
   recurrence written in PyTorch passes it; the same recurrence without
   the rescale of the running sum, or of the sum and the accumulator,
   the plain output 3% off past the first tile, and bf16 scores (the JAX
   package's ``full_attention``) each fail it.  Then the kernel, its
   plain version and PyTorch's SDPA (the yardstick, ``library_ms``) are
   timed with CUDA events at yi-9b's prefill shape T = 32,768, B = 1
   (the ``prefill_32k`` cell has global batch 32; batch 1 is the cut),
   where the kernel is checked too, at yi-9b's T = 4096 and at
   gemma-2b's shape, each with its TFLOP/s, share of the bound and ratio
   to SDPA.
7. Prefill forward of yi-9b at full width (48 layers, d_model 4096),
   random bf16 weights from ``init_params`` with a seeded generator on
   the card, at T = 4096, B = 1.  Each of the 48 launches is held
   against the plain version on its own in-model inputs (both bounds of
   phase 6), and the kernel must launch 48 times a forward.  Then the
   hidden states of the kernel path against the same ``forward`` with
   every attention through the plain version (f32 softmax), in relative
   L2, within twice the bf16 noise measured in the same run: the
   distance of the JAX package's own bf16 attention path
   (``full_attention``: bf16 scores and probabilities) from the plain
   path.  48 random layers amplify any rounding difference to about the
   same distance (a fault in a layer gives one near 1).  Then
   T = 32,768, B = 1 through the kernel path: wall time, tokens/s and
   peak memory.  After phase 8, gemma-2b's prefill (18 layers, d_model
   2048, head dim 256, MQA) at full width the same way at T = 4096: 18
   launches, each held to the plain version, and its hidden states.
8. Serving: ``DecodeEngine`` on yi-9b at full width answers 24 requests
   (prompt 96 tokens with a shared 48-token prefix, 16 new tokens,
   4 lanes, pages of 16 tokens, a 32-page pool, so the Ditto page cache
   evicts).  Every request must finish, the prefix hit rate and the
   evictions be > 0, and the page cache's four kernels have launched
   (once a lookup each).  The page cache's lookup stream is replayed
   through a fresh page cache on the card, with every launch of its four
   kernels held against the plain version on the same inputs (at the engine's shapes: one key a
   lookup on a 512-slot table), and through one on the CPU; each
   lookup's answer and the final state must equal the engine's.
   Every request's greedy tokens must equal the argmax of the prefill
   ``forward`` over its prompt and output, at every position where that
   forward's top-two logit margin exceeds twice the bf16 noise: the
   largest logit difference between the prefill and a one-lane decode
   replay of the first request's tokens.  Near-ties are counted and
   skipped; at least one position must be checked.
9. Multi-tenant: ``benchmarks/tenants.py``'s three-tenant mix scaled to
   phase 3's table (``tenant_mix`` of 4,032,000 requests over the 64
   lanes: a zipf service over 2M keys, θ 0.9, 21 lanes; a scan tenant
   over 2M hot keys with 60,000-key scans, 11 lanes; a flash crowd of up
   to 8-block objects over 4M keys, 32 lanes), ``n_tenants=3`` with the
   equal default budgets, ``sample_window=128``, ``sync_period=50``,
   through ``execute()`` in 20 chunks of lane plans at batch 32 on both
   backends.  After every chunk no tenant may be above its budget and
   ``tenant_bytes`` must equal the table's live blocks per tenant
   (recomputed on the card; the final table's also on the host).  Fused
   and reference must be bit-equal (integers; ext and gds_L within 4 ulp,
   the [T, E] weights within 16), every kernel launched once a step, each
   tenant must have lost live objects between chunks, and the flash
   tenant must have reached 90% of its budget.  Per-tenant hit ratios
   come from ``execute(..., by_lane=True)``.
10. L0: YCSB-B (95% GET, zipf 0.99) over 10M keys, 4,032,000 requests,
   one lane plan at batch 32, on phase 3's table with ``l0_entries=8``
   (``examples/dm_elastic_cache.py``'s count), on both backends and
   fused with ``l0_entries=0`` (the control).  Fused and reference must
   be bit-equal (the seven L0 client arrays and ``bucket_ver``
   included); L0 hits and invalidations both seen, fewer read bytes than
   the control and a hit ratio within 1 pp of it.
   Phases 9 and 10 each count one eager step's operators of their config
   and hold it to phase 3's whole-column rule.
11. The DM pool: phase 3's table as a ``Cluster`` of 8 memory shards x 8
   client lanes (``examples/dm_elastic_cache.py``'s topology, 64 lanes,
   route capacity q = 5), YCSB-A (zipf 0.99) over 10M keys, 6,000,000
   requests as [2929, 32, 64] groups through ``Cluster.execute`` on both
   backends.  Fused and reference must be bit-equal (hits and every
   ``DMCache`` leaf; ext and gds_L within 4 ulp, weights within 16),
   ``gets + sets + route_drops`` equal the issued requests, every shard
   must have evicted and the shards' ``n_cached`` be within 5% of each
   other; each of the four cache kernels must launch 8 times a fused DM
   step (once a shard step).  The first 64 groups re-run with
   ``sanitize=True`` (fused) must raise nothing and equal the unarmed
   run bit for bit.  One eager fused DM step's operators are counted.
12. Failover: ``benchmarks/elasticity.py``'s failover leg on phase 11's
   cluster shape, through ``run_scenario`` as the benchmark runs it:
   ``failover_trace`` (70% of requests on 48 keys homed on shard 1, the
   rest zipf over 10M keys, seed 7), 192 windows of 16 rounds x 64
   lanes, a DM step a round; shard 1 fails at window 64 and recovers
   with a rewarm at 128; a ``HealthMonitor(8)`` (two missed beats)
   marks it failed at the end of window 65, so routing to it stops from
   window 66; a replicated arm (96 hot buckets re-elected from the load
   EMA at every window) against a control.  The benchmark's three
   assertions on per-window hit ratios (the replicated dip shallower by
   more than 2 pp, fewer route drops, a rerouted-window hit ratio no
   worse by more than 0.02), the accounting, the detection window, a
   rewarm that moved objects, and no re-capture of the graph across the
   membership changes.  Then a copy with a duplicated live key in one
   bucket, run with ``sanitize=True``, must raise SAN003 when its
   segment ends.
13. The elastic pool.  (a) On phase 11's final fused cluster (8 shards
   x 8 lanes, 2,097,152 slots, capacity 1,048,576): ``with_lanes(16)``
   and ``drain_to(2,097,152)``, which must be a write of the capacity
   alone (no drain step, no migration, every other leaf the same
   tensor); 64 groups of [32, 128] of more of phase 11's YCSB-A (its
   key permutation, fresh draws); ``with_lanes(8)`` (the flush) and
   ``drain_to(524,288, batch_per_shard=512)``; ``enforce_budget``,
   which must drain nothing; 64 groups of [32, 64].  Checked: every
   shard within its capacity after the drain and within one group's
   requests of it at the end; ``n_cached``, ``bytes_cached`` and
   ``tenant_bytes`` equal a recount from the columns; no migration;
   ``evictions`` and ``hist_ctr`` moved a shard by its drained objects;
   no drained object ranked above a survivor under its shard's dominant
   expert; the lane flush and the first 8 drain steps bit-equal to the
   same calls on a host copy (the CPU leg); each cache kernel launched 8
   times a DM step in both segments, plus one capture at the new width.
   (b) ``benchmarks/elasticity.py``'s own grow -> shrink leg through
   ``run_scenario`` (YCSB-C, 60,000 requests over 20,000 keys, 4,096
   buckets x 8, one shard, lanes 32 -> 64 -> 32, capacity 8,192 ->
   16,384 -> 4,096, windows of T // 40 rounds), with its assertions (no
   migration, a drain at the shrink, ``n_cached`` at most 4,096 + 64
   after it), run without and with a ``WidthController``: every window
   equal between the two.
14. Training at full width: smollm-135m's published config (30 layers,
   d_model 576, 9 heads over 3 KV heads, d_ff 1,536, vocab 49,152),
   random bf16 params from a seeded generator on the card, T = 4,096
   (``SHAPES["train_4k"]``), a global batch of 16 (train_4k's 256 cut for
   the time limit) in 4 microbatches, ``remat="full"``, the AdamW of
   ``launch/train.py`` (lr 3e-3, 20 warmup steps).  Six steps through
   ``TrainLoop`` with a checkpoint every three; a second ``TrainLoop``
   resumes from step 3's checkpoint to step 6: its params, master, m and
   v bit-equal to the first run's, its losses equal.  No hand-written
   kernel may launch in a train step (the training path's attention is
   the plain ``full_attention`` under autograd); a prefill forward of
   the trained params must launch the flash kernel 30 times.  One f32
   train step at the smoke config on the card against the same step on
   the CPU: loss, m and v within 1e-4, the master within it where Adam's
   normalised step is well conditioned and within the step's reach (2
   lr) elsewhere.  ``compressed_allreduce(group=None)`` on the full
   134,515,008-element flat gradient of a microbatch: its first
   1,048,576 elements bit-equal to the CPU, every error within 1.01 x
   its block's scale.  Logged: ms a step, tokens/s, peak memory, model
   FLOPs a step over 989 TFLOP/s; with ``--profile``, a traced step by
   kind of kernel and the step with PyTorch's SDPA in place of the
   plain attention (a yardstick).
15. Baselines as oracles, and the examples: ``tests/test_adaptive.py``'s
   three oracle checks with the cache on the card (capacity 1,024, 8
   lanes, 60,000 requests, ``execute(plan=None)``, fused): Ditto-LRU
   within 0.05 of exact LRU (``simulate_policy``), Ditto-LRU and
   Ditto-LFU within 0.06 of ``PyDitto``, adaptive at least max(LRU, LFU)
   - 0.03 on both traces.  Meanwhile the five ``examples/torch_*.py``
   run at once, each in its own process on the card, and must exit 0
   (their asserts hold) within 300 s; their wall times are logged.
16. The rest of the LM zoo at full width and depth (nothing cut; B = 1
   prefill at T = 4096), right after gemma-2b's prefill, which must leave
   under 4 GiB allocated: olmoe-1b-7b (16 x ``attn_moe``, 64 experts top
   8), moonshot-v1-16b-a3b (48 x ``attn_moe``, top 6), recurrentgemma-2b
   (8 x (rglru, rglru, attn_local) and 2 rglru remainder blocks),
   xlstm-350m (3 x 8 mLSTM / sLSTM blocks), internvl2-1b and
   musicgen-large (dense ``attn`` behind stub frontends, through
   ``forward(embeds=)``), random bf16 weights from ``init_params`` with a
   seeded generator on the card.  The archs with causal attention go
   through phase 7's checks: the flash kernel launches once per ``attn``
   or ``attn_moe`` layer, each launch held to the plain version on its
   in-model inputs, the hidden states within twice the bf16 noise of the
   plain-attention path; logged: tokens/s, peak memory, the model-FLOP
   share of 989 TFLOP/s from active params and, for the MoE archs, the
   share of (token, choice) pairs the capacity dropped.  recurrentgemma
   and xlstm launch no hand-written kernel (``attn_local`` is the plain
   windowed attention, the recurrences are plain torch), and on 64
   tokens of one lane their decode is held to their prefill: with every
   cache in f32 and f32 params within 1e-4 in relative L2; with the JAX
   package's cache dtypes (recurrentgemma's f32 params, xlstm's bf16)
   within twice the bf16 noise (the bf16 prefill's distance from the f32
   one), xlstm's argmax equal wherever the prefill's top-two margin
   exceeds twice that position's bf16-vs-f32 logit difference (JAX's own
   1e-2 margin is counted and logged: at 64 positions JAX's bf16 decode
   flips there too).  Then 128 lanes decode 16 steps (new tokens/s), the
   cache's bytes equal at seq_len 4096 and 32,768.  One more prefill of
   each arch times its plain layers between syncs (the MoE blocks and
   one's operator count, the RG-LRU scans, the windowed attention, the
   sLSTM loops) as shares of that forward's wall.
17. The mesh slice.  (a) The fake-rank dry run (``launch/dryrun.py``) of
   ``MESH_CELLS`` on both production meshes, (data=16, model=16) and
   (pod=2, data=16, model=16), over fake CUDA tensors, so the dispatched
   operators are the card's (the flash kernel's operator); any
   ``failed`` cell fails the phase.  (b) The card's achieved bf16 matmul
   rate and copy bandwidth beside the roofline's spec-sheet constants;
   at yi-9b and gemma-2b prefill, B = 1, T = 4096, with DTensor params on
   the one-rank mesh, the op counter's FLOPs of each flash call equal
   PERF.md's hand-worked bound (139 and 69.5 us), and neither the
   forward nor one flash call measures under 0.95 of its roofline bound
   (a counter that missed work).  (c) On the one-rank mesh: that
   prefill launches the flash kernel once a layer under DTensor and
   equals the plain forward bit for bit; a smollm-135m train step at
   phase 14's config with 2 microbatches and batch 4, DTensor params and
   the ZeRO-1 specs live, equals the plain step bit for bit.  (d) The
   graph audit (``analysis/audit.py``) of the cache entry points over
   CUDA tensors: only the mirrored dead outputs (``audit.MIRRORED``:
   the JAX package's audit reports four of the five).  (e) The lint of
   ``src/repro_torch``: no finding.
18. The pool across ranks (``Cluster.make(..., group=)``,
   ``dm/ranks.py``), phase 11's cluster at full size, run right after
   phase 13.  (a) A one-rank NCCL group in this process, all 8 shards
   local: every ``DMCache`` leaf and the hits bit-equal to phase 11's
   fused run (weights at 0 ulp), each cache kernel launched 8 times a DM
   step.  (b) R = 2 and R = 4 processes (``torch.multiprocessing``,
   spawn) on this card over ``gloo``, joined by a ``FileStore`` in a
   git-ignored directory: each rank's shards bit-equal to its block of
   phase 11's fused run and the hits on every rank; on R = 4 also
   phase 12's replicated arm through ``run_scenario`` (window by window
   and event by event) and phase 13 (a)'s sequence (its reports and
   final leaves).  (c) Where there are two or more cards, one rank a
   card over NCCL runs (a)'s check; on one card a line says it did not
   run.  The kernels are built here before any rank starts; a rank's
   non-zero exit fails the phase.  Each arm logs its requests/s and µs
   a DM step.

Launch counts are the kernels' own: each kernel adds one to a counter
on the device, also when its launch is replayed from a CUDA graph; the
counters are set to 0 just before each run of a main path (the
``kernels.ops`` entry point's, the cache's, the prefill forward's, the
engine's, phase 9's, 10's, 11's, 12's arms and 13's segments and
scenario runs, phase 14's training loop and prefill, phase 15's oracle
runs, phase 16's prefills and decodes, phase 18's runs, each rank's in
its own process) and read just after it.

The second-to-last line is the kernels' JSON record (each with the
launch floor, ``floor_ms``), the last line
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
SEED = 0
N_BUCKETS, ASSOC, CAPACITY = 262_144, 8, 1_048_576
LANES, BATCH = 64, 32
N_KEYS = 10_000_000
SEQ_ROUNDS = 1_000
ADAPTIVE_ROWS = 2_000
EXPERTS_ALL = ("lru", "lfu", "fifo", "size", "hyperbolic")
CACHE_KERNELS = ("access_probe", "hit_metadata_update", "ranked_eviction",
                 "drop_scatter")
# The kernels that only the kernels.ops entry point reaches, and the Get
# batches of 2048 keys its counted path drives through them.
ENTRY_KERNELS = ("sampled_eviction", "bucket_lookup", "metadata_update")
ENTRY_STEPS = 8
# metadata_update's cases, each at every B of MD_BATCHES: where the slots
# fall against the kernel's tiles of the table (kernels/metadata_update.py
# ::TILE slots a CTA).
MD_CASES = ("one_slot", "pairs", "one_tile", "tile_edges", "no_ops",
            "mixed")
MD_BATCHES = (1, 63, 2048, 65_536)
# bucket_lookup's bucket widths, each on a table whose C is not a multiple
# of it (assoc 1 aside), at every B of BL_BATCHES.
BL_ASSOCS = (1, 4, 6, 8, 16, 64)
BL_BATCHES = (1, 63, 2048)
# Phase 6: (arch, B, T, H, D, H / Hkv) of the three attention shapes.
FLASH_SHAPES = (("yi-9b", 1, 4096, 32, 128, 8),
                ("smollm-135m", 4, 2048, 9, 64, 3),
                ("gemma-2b", 1, 4096, 8, 256, 8))
# Each element within tol + tol*|want| of the plain version's output, as
# tests/test_kernels.py holds the Pallas kernel; too loose to see a fault
# in the late rows, whose values are a few hundredths at T = 32,768.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# The sharper bound: each output row's (b, t, h) relative L2 error against
# the plain version's f32 output.  In bf16 about twice the largest reading
# on an H100 (PERF.md: 3.7e-3, the bf16 rounding of the output and of the
# probabilities), and under what a 3% error in a row (3.3e-2) or bf16
# scores (1.8e-2) give; phase 6's controls check both sides of it on every
# run.  In f32 with room for the error's growth with T (2.3e-6 at
# T = 4096).
FLASH_ROW_TOL = {"bfloat16": 2 ** -7, "float32": 2 ** -16}
FLASH_TILE = 128        # the bf16 kernel's query tile; its KV tile at D <= 128
PREFILL_T, PREFILL_LONG_T = 4096, 32_768
# Phase 16: the zoo's last six archs at full width, B = 1 prefill; the
# recurrent archs' decode checked on 64 tokens and run at 128 lanes.
ZOO_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "recurrentgemma-2b",
             "xlstm-350m", "internvl2-1b", "musicgen-large")
ZOO_START_GIB = 4           # the most allocated when the phase starts
ZOO_CHECK_T = 64
ZOO_F32_TOL = 1e-4          # f32 decode with f32 caches against the prefill
ZOO_DECODE = dict(lanes=128, steps=16, seq_len=4096)
# Phase 9: benchmarks/tenants.py's three-tenant mix scaled to the table
# (a steady zipf service, an LFU-friendly scan tenant, a flash crowd of
# 8-block objects), run in CHUNKS chunks; phase 10: YCSB-B with the L0
# entry count of examples/dm_elastic_cache.py.
MIX_REQUESTS = 4_032_000
TENANT_SPECS = (dict(kind="zipf", n_keys=2_000_000, theta=0.9, lanes=21),
                dict(kind="scan", hot_keys=2_000_000, scan_len=60_000,
                     lanes=11),
                dict(kind="flash", hot_keys=4_000_000, max_blocks=8,
                     lanes=32))
CHUNKS = 20
L0_ENTRIES = 8
# Phase 11: examples/dm_elastic_cache.py's 8 shards x 8 lanes on phase 3's
# table (64 lanes), YCSB-A; its first DM_SAN_GROUPS groups re-run armed.
# Phase 12: benchmarks/elasticity.py's failover leg (its window of 16
# rounds a group, 70% of requests on 48 keys homed on the shard that
# fails, 96 replicated buckets) on that cluster.
DM_SHARDS, DM_LANES, DM_ROUTE = 8, 8, 4
DM_REQUESTS = 6_000_000
DM_SAN_GROUPS = 64
DM_BALANCE = 0.05       # the most the shards' n_cached may spread, / mean
FAIL_GROUPS, FAIL_WINDOW, FAIL_SHARD, FAIL_HOT = 192, 16, 1, 96
FAIL_AT, RECOVER_AT = 64, 128
# Phase 13: benchmarks/elasticity.py's grow -> shrink leg (lanes 32 -> 64
# -> 32 in all, capacity x2 then a quarter of that) on phase 11's cluster;
# the drain's batch is the benchmark's 64 at 32,768 slots a shard, scaled
# to 262,144.  The CPU leg repeats the lane flush and the first drain steps.
ELASTIC_LANES, ELASTIC_GROUPS, ELASTIC_BATCH = (16, 8), 64, 512
ELASTIC_CPU_STEPS = 8
SCENARIO_REQUESTS, SCENARIO_KEYS = 60_000, 20_000
ENGINE = dict(requests=24, prompt=96, shared=48, new=16, lanes=4,
              page_size=16, pool_pages=32)
# Phase 14: smollm-135m at full width on train_4k's sequence length; the
# global batch cut from train_4k's 256 to 16 for the script's time limit.
TRAIN = dict(arch="smollm-135m", batch=16, microbatches=4, remat="full",
             steps=6, ckpt_every=3, lr=3e-3)
TRAIN_TOL = 1e-4        # the smoke step, card against CPU
COMPRESS_HELD = 1 << 20     # elements of the flat gradient held to the CPU
PEAK_BF16 = 989e12          # H100 SXM dense bf16 (data sheet)
# Phase 15: tests/test_adaptive.py's sizes and bounds.
ORACLE = dict(capacity=1024, clients=8, requests=60_000)
EXAMPLES = ("quickstart", "multi_tenant_cache", "dm_elastic_cache",
            "serve_with_prefix_cache", "train_lm")
EXAMPLE_TIMEOUT = 300


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Timing and comparison helpers.
# ---------------------------------------------------------------------------

def time_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: n calls captured in one CUDA graph and
    replayed reps times between two CUDA events, so the host's launch
    cost is not in the number (the inputs stay in L2 between calls)."""
    import torch
    from repro_torch.core.cache import capture_graph
    graph, _ = capture_graph(lambda: [fn() for _ in range(n)])
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def eager_ms(fn, n: int = 50) -> float:
    """Time of one call launched from Python, host cost included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def ulp_diff(x, y) -> int:
    """Max distance in units of the last place between two f32 arrays."""
    import numpy as np
    xi = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    yi = np.asarray(y, np.float32).view(np.int32).astype(np.int64)
    xi = np.where(xi < 0, -(xi & 0x7FFFFFFF), xi)
    yi = np.where(yi < 0, -(yi & 0x7FFFFFFF), yi)
    return int(np.max(np.abs(xi - yi), initial=0))


def same_int(name, got, want) -> None:
    import torch
    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{name}: {bad} integer elements differ")


def close_f32(name, got, want, maxulp: int) -> float:
    import torch
    got, want = got.cpu(), want.cpu()
    d = ulp_diff(got.numpy(), want.numpy())
    if d > maxulp:
        raise AssertionError(f"{name}: {d} ulp apart (bound {maxulp})")
    diff = torch.where(got == want, 0.0, got.double() - want.double())
    return float(diff.abs().max()) if got.numel() else 0.0


# The f32 columns that compound every weight sync's exp rounding.
COMPOUNDED = ("weights", "local_weights", "penalty_acc")


def same_parts(tag: str, a, b, maxulp: int,
               weight_ulp: int | None = None) -> None:
    """Two (state, clients, stats) triples: integers bit-equal, f32
    within maxulp (the COMPOUNDED columns within ``weight_ulp`` if
    given)."""
    for part, ta, tb in zip(("state", "clients", "stats"), a, b):
        for f in ta._fields:
            x, y = getattr(ta, f), getattr(tb, f)
            if x.dtype.is_floating_point:
                close_f32(f"{tag}.{part}.{f}", x, y,
                          weight_ulp if weight_ulp is not None
                          and f in COMPOUNDED else maxulp)
            else:
                same_int(f"{tag}.{part}.{f}", x, y)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version on a full-size table.
# ---------------------------------------------------------------------------

def random_table(rng, n_buckets: int, assoc: int, hist_ctr: int,
                 history_len: int):
    """A filled table as numpy int64 columns: live keys in their own
    buckets, history entries (some past history_len, some with ptr ahead
    of hist_ctr, so the age wraps mod 2^32), empty slots."""
    import numpy as np
    from repro_torch.core.hashing import splitmix32
    import torch
    n = n_buckets * assoc
    cand = rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.int64)
    kh = splitmix32(torch.from_numpy(cand)).numpy()
    bucket = kh % n_buckets
    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    first = np.searchsorted(b_sorted, b_sorted, side="left")
    rank = np.arange(n) - first
    keep = rank < assoc
    slot = b_sorted[keep] * assoc + rank[keep]
    key = np.zeros(n, np.int64)
    khash = np.zeros(n, np.int64)
    key[slot] = cand[order][keep]
    khash[slot] = kh[order][keep]
    filled = np.zeros(n, bool)
    filled[slot] = True
    kind = rng.random(n)
    size = np.where(kind < 0.6, rng.integers(1, 9, n), 255)
    size = np.where(filled, size, 0).astype(np.int64)
    age = rng.integers(0, 2 * history_len, n)
    ptr = np.where(size == 255, (hist_ctr - age) % 2**32, 0).astype(np.int64)
    return dict(key=key, key_hash=khash, size=size, ptr=ptr)


def apply_groups(rng, dev, n: int, B: int, keys, ts, u32, K: int = 5):
    """The cache step's three write groups at its shapes (B ops, K victims
    an op, an n-row table), as a function of the nine columns they write
    (key, key_hash, size, ptr, insert_ts, last_ts, freq, ext, values):
    SET (B entries, half at distinct slots, the rest at the dropped index
    n), inserts (B entries, a third kept by their mask, at distinct slots,
    8 of them SET slots) and evictions (B * K entries, 1% kept by their
    mask, at distinct slots, 8 of them insert targets; size and ptr from
    selects of a history flag, as the step gives them)."""
    import numpy as np
    import torch
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    n_set = B // 2
    ins_ok = rng.random(B) < 1 / 3
    ev_ok = rng.random(B * K) < 0.01
    n_ins, n_ev = int(ins_ok.sum()), int(ev_ok.sum())
    pool = rng.choice(n, n_set + n_ins + n_ev, replace=False)
    set_idx = np.full(B, n)
    set_idx[rng.choice(B, n_set, replace=False)] = pool[:n_set]
    ins_slot = rng.integers(0, n, B)
    ins_slot[ins_ok] = pool[n_set - 8:n_set - 8 + n_ins]
    victims = np.full(B * K, -1)
    victims[ev_ok] = pool[n_set + n_ins - 16:n_set + n_ins - 16 + n_ev]
    victims[~ev_ok & (rng.random(B * K) < 0.3)] = rng.integers(0, n)
    vals, sz = t(u32(2 * B).reshape(B, 2)), t(rng.integers(1, 9, B))
    hist = t(rng.random(B * K) < 0.6)
    ins_src = (keys, t(u32(B)), sz, 0, ts, ts, 1,
               t(rng.random((B, 4), np.float32)), vals)
    ev_src = ((hist, 255, 0), (hist, t(u32(B * K)), 0),
              t(rng.integers(0, 8, B * K)))
    idx = [t(a) for a in (set_idx, ins_slot, victims)]
    masks = [t(a) for a in (ins_ok, ev_ok)]

    def groups(cols):
        key, kh, size, ptr, ins, last, freq, ext, values = cols
        return ((idx[0], (values, size), (vals, sz)),
                (idx[1], cols, ins_src, masks[0]),
                (idx[2], (size, ptr, ins), ev_src, masks[1]))
    return groups


# The float sums of the step, the weight sync and the drain, in XLA's CPU
# order (f32 adds one at a time): held against a host f32 loop.
REDUCE_ROWS = (1, 2, 4, 7, 31, 32, 33, 40, 64, 65, 100, 128, 1025, 2048,
               5000)


def check_reductions(dev) -> dict:
    """The F1 check: ``core/cache.py``'s ordered sums on the card
    (``_seqsum``, ``_xla_sum0``, ``_seqsum_last``, ``_seqcumsum_last``,
    ``_expert_cdf``, ``apply_penalties``' normalisation and the drain's
    ``_tenant_mean``) against a host f32 loop in numpy on the same
    seeded inputs, at 1 to 5,000 rows and E = 1 to 8, with 1 and 3
    columns (a lone column takes the widened path): every output
    bit-equal (past 1,024 rows XLA's row ranges nest)."""
    import numpy as np
    import torch
    from repro_torch.core import cache
    from repro_torch.elastic.resize import _tenant_mean

    f32 = np.float32

    def seq(x):                              # rows in order, f32
        acc = x[0].copy()
        for row in x[1:]:
            acc = (acc + row).astype(f32)
        return acc

    def xla0(x):                             # XLA's CPU reduce, written
        n = x.shape[0]                       # apart from cache._xla_chunks
        if n <= 32:
            return seq(x)
        k = (n + 31) // 32                   # ranges: the middle ones of
        first = (n - 32 * (k - 2) + 1) // 2  # 32, the first and last even
        cuts = [0] + list(range(first, first + 32 * (k - 2) + 1, 32)) + [n]
        return xla0(np.stack([seq(x[a:b]) for a, b in zip(cuts, cuts[1:])]))

    def cum_last(x):
        out = x.copy()
        for i in range(1, x.shape[-1]):
            out[..., i] = (out[..., i - 1] + x[..., i]).astype(f32)
        return out

    def sum_last(x):
        return seq(np.moveaxis(x, -1, 0))

    def norm(w):
        w = np.maximum(w, f32(1e-4))
        return (w / sum_last(w)[..., None]).astype(f32)

    def cdf(w):
        s = np.maximum(sum_last(w), f32(1e-30))
        return cum_last((w / s[..., None]).astype(f32))

    cases = {
        "seqsum": (cache._seqsum, seq),
        "xla_sum0": (cache._xla_sum0, xla0),
        "seqsum_last": (cache._seqsum_last, sum_last),
        "seqcumsum_last": (cache._seqcumsum_last, cum_last),
        "expert_cdf": (cache._expert_cdf, cdf),
        "apply_penalties": (lambda w: cache.apply_penalties(
            w, torch.zeros_like(w), 0.1), norm),
        "tenant_mean": (_tenant_mean, lambda x: (xla0(x) * (
            f32(1) / f32(x.shape[0]))).astype(f32)),
    }
    rng = np.random.default_rng(SEED)
    n = bad = 0
    worst = []
    for R in REDUCE_ROWS:
        for E in range(1, 9):
            for cols in ((), (1,), (3,)):
                x = (rng.random((R,) + cols + (E,), dtype=f32)
                     * rng.choice(f32([1e-3, 1.0, 1e3]), (R,) + cols + (E,)))
                xt = torch.from_numpy(x).to(dev)
                for name, (fn, host) in cases.items():
                    got = fn(xt).cpu().numpy()
                    want = host(x)
                    n += 1
                    if got.shape != want.shape or not np.array_equal(
                            got.view(np.int32), want.view(np.int32)):
                        bad += 1
                        worst.append((name, R, E, cols))
    log(f"F1: {n} cases of the ordered sums on the card ({len(cases)} "
        f"functions, rows {REDUCE_ROWS[0]}-{REDUCE_ROWS[-1]}, E = 1-8): "
        f"{n - bad} bit-equal to a host f32 loop")
    if bad:
        raise AssertionError(f"F1: {bad} of {n} ordered sums differ from a "
                             f"host f32 loop on the card: {worst[:8]}")
    return dict(cases=n, rows=list(REDUCE_ROWS), experts=8)


def check_kernels(dev, results: dict) -> float:
    """Phase 2; returns the launch floor, ms."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    n_slots = N_BUCKETS * ASSOC
    hist_ctr, history_len = 1_000, CAPACITY
    tab = random_table(rng, N_BUCKETS, ASSOC, hist_ctr, history_len)
    t = {k: torch.from_numpy(v).to(dev) for k, v in tab.items()}
    hctr = torch.tensor(hist_ctr, dtype=torch.int64, device=dev)
    live = np.nonzero((tab["size"] > 0) & (tab["size"] < 255))[0]
    hist = np.nonzero(tab["size"] == 255)[0]
    u32 = lambda m: rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.int64)

    # Metadata columns of the table (u32 values) and ext.
    freq = torch.from_numpy(rng.integers(0, 2**32, n_slots, dtype=np.uint64)
                            .astype(np.int64) % 50_000).to(dev)
    last = torch.from_numpy(rng.integers(0, 2**32, n_slots, dtype=np.uint64)
                            .astype(np.int64) % 1_000_000).to(dev)
    ins = torch.from_numpy(rng.integers(0, 1_000_000, n_slots)).to(dev)
    ext = torch.from_numpy(rng.random((n_slots, 4), np.float32) * 1e5).to(dev)
    tenant = torch.from_numpy(rng.integers(0, 4, n_slots)).to(dev)

    def probe_keys(B):
        # Live keys, keys of history entries (valid or aged out), random
        # misses, duplicates and the no-op key 0.
        u = rng.random(B)
        k = np.where(u < 0.4, tab["key"][rng.choice(live, B)],
                     np.where(u < 0.6, tab["key"][rng.choice(hist, B)],
                              u32(B)))
        k[rng.random(B) < 0.1] = 0
        k[B // 2:B // 2 + 4] = k[0]
        return torch.from_numpy(k).to(dev)

    shapes = {}
    for B in (64, 2048):
        keys = probe_keys(B)
        args = (t["key"], t["size"], t["key_hash"], t["ptr"], keys, hctr)
        # The probe alone, and with the insert path's facts (the cache
        # step's form: every expert choice's bucket argmin, E included).
        ts = torch.from_numpy(1_000_000 + rng.integers(0, 32, B)).to(dev)
        for form, kw in (("alone", dict(assoc=ASSOC,
                                          history_len=history_len)),
                         ("facts", dict(assoc=ASSOC, history_len=history_len,
                                        meta=(ins, last, freq), ts=ts,
                                        experts=EXPERTS_ALL))):
            got = ops.access_probe_op(*args, **kw)
            want = ref.access_probe_ref(*args, **kw)
            names = ("found", "slot", "hist_found", "hist_slot")
            if form == "facts":
                names += tuple(got[4]._fields)
                got, want = (got[:4] + tuple(got[4]),
                             want[:4] + tuple(want[4]))
            for name, g, w in zip(names, got, want):
                same_int(f"access_probe[B={B},{form}].{name}", g, w)
            if not (bool(got[0].any()) and bool(got[2].any())):
                raise AssertionError("access_probe: no key or history match")
            shapes[("access_probe" if form == "facts" else
                    "access_probe_alone", B)] = (args, kw)

        # hit_metadata_update: duplicate hits, -1 no-ops, emits with
        # duplicates (the main path's emit width is C * (2F + G)).
        hit = rng.choice(live, B).astype(np.int64)
        hit[rng.random(B) < 0.3] = -1
        hit[1:9] = hit[0] if hit[0] >= 0 else live[0]
        hts = (1_000_000 + rng.integers(0, 32, B)).astype(np.int64)
        Be = LANES * (2 * 64 + BATCH) if B == 2048 else 2 * B
        emit = np.full(Be, -1, np.int64)
        m = rng.random(Be) < 0.05
        emit[m] = rng.choice(live, int(m.sum()))
        emit[:4] = hit[0]
        delta = np.where(emit >= 0, rng.integers(1, 11, Be), 0)
        args = tuple(torch.from_numpy(a).to(dev) for a in (hit, hts, emit,
                                                           delta))
        margs = (freq, last, ext) + args
        # The in-place kernel on copies of the columns and its functional
        # form, each bit-equal to the plain version; then every hit on one
        # slot, and flushes on exactly the hit slots (the FAA must not
        # reach a slot before its ext update has read the step-entry freq).
        one = np.full(B, hit[0] if hit[0] >= 0 else live[0], np.int64)
        cases = (("", args),
                 (",one slot", tuple(torch.from_numpy(a).to(dev) for a in (
                     one, hts, np.full(Be, one[0]), np.ones(Be, np.int64)))),
                 (",flush at hits", tuple(torch.from_numpy(a).to(dev) for a in (
                     hit, hts, hit, np.where(hit >= 0, 3, 0)))))
        for tag, cargs in cases:
            want = ref.hit_metadata_update_ref(freq, last, ext, *cargs)
            got = tuple(c.clone() for c in (freq, last, ext))
            ops.hit_metadata_update_op_(*got, *cargs)
            for form, g in (("in place", got), ("functional",
                            ops.hit_metadata_update_op(freq, last, ext,
                                                       *cargs))):
                what = f"hit_metadata_update[B={B}{tag}, {form}]"
                same_int(f"{what}.freq", g[0], want[0])
                same_int(f"{what}.last_ts", g[1], want[1])
                same_bits(f"{what}.ext", g[2], want[2])
        results.setdefault("hit_metadata_update", {})["max_abs_err"] = 0.0
        shapes[("hit_metadata_update", B)] = (margs, {})

        # drop_scatter: the apply's three write groups in one launch at
        # the main path's shapes: SET (B entries, last-writer-wins
        # indices, two columns), inserts (B entries masked, all nine
        # columns, numbers and rows) and evictions (B * K entries masked,
        # select sources), with collisions across the groups.
        cols = (t["key"], t["key_hash"], t["size"], t["ptr"], ins, last, freq,
                ext, torch.from_numpy(u32(2 * n_slots).reshape(n_slots, 2))
                .to(dev))
        groups = apply_groups(rng, dev, n_slots, B, keys, args[1], u32)
        copies = [tuple(c.clone() for c in cols) for _ in range(2)]
        got, want = copies
        ops.drop_scatter_groups_op_(groups(got))
        ref.drop_scatter_groups_ref(groups(want))
        for k, (g, w) in enumerate(zip(got, want)):
            (same_bits if g.is_floating_point() else same_int)(
                f"drop_scatter[B={B}].col{k}", g, w)
        if torch.equal(got[0], cols[0]) or torch.equal(got[3], cols[3]):
            raise AssertionError("drop_scatter wrote nothing")
        results.setdefault("drop_scatter", {})["max_abs_err"] = 0.0
        shapes[("drop_scatter", B)] = ((groups(copies[0]),), {})
        shapes[("drop_scatter_insert", B)] = (groups(copies[1])[1], {})

        # ranked_eviction: all five kernel experts, W = 20 and W = 128,
        # per-op quota up to 3, tenant filters; then the main path's form.
        for W, K, experts, filt in ((20, 5, EXPERTS_ALL, False),
                                    (128, 5, EXPERTS_ALL, True),
                                    (132, 33, EXPERTS_ALL, True),
                                    (128, 64, ("lru", "hyperbolic"), False),
                                    (20, 5, ("lru", "lfu"), False)):
            E = len(experts)
            offs = torch.from_numpy(rng.integers(0, n_slots, B)).to(dev)
            ech = torch.from_numpy(rng.integers(0, E, B)).to(dev)
            must = torch.from_numpy(rng.random(B) < 0.8).to(dev)
            quota = torch.from_numpy(rng.integers(0, 4 if K <= 5 else 4 * K,
                                                  B)).to(dev)
            ts = torch.from_numpy(1_000_000 + rng.integers(0, 32, B)).to(dev)
            tf = torch.from_numpy(np.where(rng.random(B) < 0.5, -1,
                                           rng.integers(0, 4, B))).to(dev)
            rargs = (t["size"], ins, last, freq, offs, ech, must, quota, ts)
            rkw = dict(window=W, k=K, experts=experts,
                       tenant=tenant if filt else None,
                       tfilt=tf if filt else None)
            got = ops.ranked_eviction_op(*rargs, **rkw)
            want = ref.ranked_eviction_ref(*rargs, **rkw)
            tag = f"ranked_eviction[B={B},W={W},K={K},E={E}]"
            same_int(f"{tag}.victims", got[0], want[0])
            same_int(f"{tag}.cand", got[1], want[1])
            if int((got[0] >= 0).sum()) == 0:
                raise AssertionError("ranked_eviction took no victim")
        log(f"kernels agree with their plain versions at B={B}")
    check_draw_form(dev, rng, t["size"], (ins, last, freq), shapes)

    # Timing at the main path's shape (B = G * C = 2048) on this table.
    # The in-place kernels write copies of the columns, so the later
    # phases read the table as it was.
    torch.cuda.synchronize()
    from repro_torch.kernels import runtime
    from repro_torch.kernels.bucket_lookup import access_probe
    from repro_torch.kernels.metadata_update import hit_metadata_update_
    from repro_torch.kernels.sampled_eviction import (ranked_eviction,
                                                      ranked_eviction_draw)
    from repro_torch.kernels.scatter import drop_scatter
    floor_ms = time_ms(lambda: runtime.launch_floor(dev))
    log(f"launch floor: an empty kernel takes {floor_ms * 1e3:.2f} us a "
        f"launch in the same harness")
    margs, _ = shapes[("hit_metadata_update", 2048)]
    (groups,), _ = shapes[("drop_scatter", 2048)]
    four = lambda gs: tuple((*g, None)[:4] for g in gs)   # the launcher's form
    timed = {"hit_metadata_update": (tuple(a.clone() for a in margs[:3])
                                     + margs[3:], {}),
             "drop_scatter": ((four(groups),), {})}
    # ranked_eviction in the main path's form (the draw form), then the
    # form given the same offsets and choices.
    kern = {"access_probe": (access_probe, ref.access_probe_ref),
            "hit_metadata_update": (hit_metadata_update_,
                                    ref.hit_metadata_update_ref_),
            "ranked_eviction": (ranked_eviction_draw,
                                ref.ranked_eviction_draw_ref),
            "drop_scatter": (drop_scatter, ref.drop_scatter_groups_ref)}
    for name, (k_fn, p_fn) in kern.items():
        args, kw = timed.get(name, shapes[(name, 2048)])
        r = results.setdefault(name, {})
        r["ms"] = time_ms(lambda: k_fn(*args, **kw))
        r["plain_ms"] = time_ms(lambda: p_fn(*args, **kw))
        r["eager_ms"] = eager_ms(lambda: k_fn(*args, **kw))
        r["bytes"] = bound_bytes(name, args, kw)
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r.setdefault("max_abs_err", 0.0)
        log(f"{name} at B=2048: {r['ms'] * 1e3:.2f} us a call on the "
            f"device ({r['eager_ms'] * 1e3:.2f} us launched from Python), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes']} bytes)")
    args, kw = shapes[("ranked_eviction_given", 2048)]
    r = results["ranked_eviction"]
    r["ms_given"] = time_ms(lambda: ranked_eviction(*args, **kw))
    r["plain_ms_given"] = time_ms(lambda: ref.ranked_eviction_ref(*args,
                                                                  **kw))
    r["bound_ms_given"] = (bound_bytes("ranked_eviction_given", args, kw)
                           / HBM_BYTES_PER_S * 1e3)
    log(f"ranked_eviction given the same offsets and choices: "
        f"{r['ms_given'] * 1e3:.2f} us, plain "
        f"{r['plain_ms_given'] * 1e3:.2f} us, bound "
        f"{r['bound_ms_given'] * 1e3:.3f} us")
    # The draw form's tenant case at phase 9's shape (W = 128), beside the
    # untenanted draw form at the same W on the same inputs.
    args, kw = shapes[("ranked_eviction_tenant", 2048)]
    r["ms_tenant"] = time_ms(lambda: ranked_eviction_draw(*args, **kw))
    r["plain_ms_tenant"] = time_ms(lambda: ref.ranked_eviction_draw_ref(
        *args, **kw))
    r["bound_ms_tenant"] = (bound_bytes("ranked_eviction_tenant", args, kw)
                            / HBM_BYTES_PER_S * 1e3)
    args, kw = shapes[("ranked_eviction_w128", 2048)]
    r["ms_w128"] = time_ms(lambda: ranked_eviction_draw(*args, **kw))
    log(f"ranked_eviction's draw form with tenants (W = 128, K = 5, 3 of 4 "
        f"tenants' rows): {r['ms_tenant'] * 1e3:.2f} us, plain "
        f"{r['plain_ms_tenant'] * 1e3:.2f} us, bound "
        f"{r['bound_ms_tenant'] * 1e3:.3f} us; untenanted at W = 128 "
        f"{r['ms_w128'] * 1e3:.2f} us")
    # The other forms: the probe alone (the entry point's and the tests'),
    # and the insert write as one group (the apply's launch before it
    # took all three groups at once).
    args, kw = shapes[("access_probe_alone", 2048)]
    r = results["access_probe"]
    r["ms_alone"] = time_ms(lambda: access_probe(*args, **kw))
    r["bound_ms_alone"] = (bound_bytes("access_probe", args, kw)
                           / HBM_BYTES_PER_S * 1e3)
    group, _ = shapes[("drop_scatter_insert", 2048)]
    r = results["drop_scatter"]
    r["ms_insert_group"] = time_ms(lambda: drop_scatter(four((group,))))
    r["bound_ms_insert_group"] = (bound_bytes("drop_scatter", ((group,),), {})
                                  / HBM_BYTES_PER_S * 1e3)
    log(f"access_probe alone (no facts): "
        f"{results['access_probe']['ms_alone'] * 1e3:.2f} us; drop_scatter "
        f"of the insert group alone: {r['ms_insert_group'] * 1e3:.2f} us")
    # The functional form (the entry point's and the tests'; the cache
    # step calls the in-place kernel): copies of the three columns, each
    # read once and written once, then the kernel.
    r = results["hit_metadata_update"]
    r["copy_ms"] = time_ms(lambda: tuple(a.clone() for a in margs[:3]))
    r["copy_bound_ms"] = (2 * sum(a.numel() * a.element_size()
                                  for a in margs[:3]) / HBM_BYTES_PER_S * 1e3)
    r["wrapper_ms"] = time_ms(lambda: ops.hit_metadata_update_op(*margs))
    log(f"hit_metadata_update's functional form (entry point and tests "
        f"only): its copy {r['copy_ms'] * 1e3:.2f} us, bound "
        f"{r['copy_bound_ms'] * 1e3:.2f} us; copy and kernel together "
        f"{r['wrapper_ms'] * 1e3:.2f} us")
    check_entry_point(dev, rng, t, dict(ins=ins, last=last, freq=freq), live,
                      probe_keys, results)
    return floor_ms


def check_draw_form(dev, rng, size, meta, shapes: dict) -> None:
    """Phase 2: ranked_eviction's draw form (the fused step's: each op's
    threefry draw, expert choice and victim bitmaps in the kernel) against
    its plain version on the full table, at B = 1, 63 and 2048, K = 5, 33
    and 64 (W = 20, 66, 128) and E = 1, 2 and 5: 64 lanes' keys, every
    seventh lane's weights summing below 1e-30 (a cdf below every draw:
    the choice E, which takes no victim), a per-op or a scalar quota, and
    timestamps that wrap past 2^32.  Then the main path's shape (B = 2048
    in 32 rounds of 64 lanes, W = 20, K = 5, lru and lfu, one quota) for
    the timing, in both forms on the same offsets and choices."""
    import numpy as np
    import torch
    from repro_torch.core.cache import _expert_cdf
    from repro_torch.kernels import ops, ref

    def inputs(B, experts, starve):
        w = rng.random((LANES, len(experts))).astype(np.float32) + 1e-4
        if starve:
            w[::7] = 1e-32
        keys = rng.integers(0, 2**32, (LANES, 2), dtype=np.uint64)
        return (torch.from_numpy(keys.astype(np.int64)).to(dev),
                _expert_cdf(torch.from_numpy(w)).to(dev),
                torch.from_numpy(rng.random(B) < 0.8).to(dev))

    n = size.shape[0]
    for B in (1, 63, 2048):
        ts = torch.from_numpy((2**32 - 16 + np.arange(B) // LANES)
                              % 2**32).to(dev)
        for W, K in ((20, 5), (66, 33), (128, 64)):
            for experts in (("hyperbolic",), ("lru", "lfu"), EXPERTS_ALL):
                E = len(experts)
                keys, cdf, must = inputs(B, experts, True)
                quota = (torch.tensor(2, device=dev) if B == 63 else
                         torch.from_numpy(rng.integers(0, 4 * K, B)).to(dev))
                args = (size, *meta, keys, cdf, must, quota, ts)
                kw = dict(window=W, k=K, experts=experts)
                got = ops.ranked_eviction_draw_op(*args, **kw)
                want = ref.ranked_eviction_draw_ref(*args, **kw)
                tag = f"ranked_eviction draw[B={B},W={W},K={K},E={E}]"
                for name, g, w in zip(("victims", "cand", "e_choice", "bmap"),
                                      got, want):
                    same_int(f"{tag}.{name}", g, w)
                if B == 2048 and not (bool((got[2] == E).any())
                                      and int((got[0] >= 0).sum()) > 0):
                    raise AssertionError(f"{tag}: no choice E or no victim")
    log("ranked_eviction's draw form agrees with its plain version at "
        "B = 1, 63, 2048 x K = 5, 33, 64 x E = 1, 2, 5 (bit-equal; lanes "
        "whose cdf stays below the draw choose E and take no victim)")
    B = 2048
    keys, cdf, must = inputs(B, ("lru", "lfu"), False)
    ts = torch.from_numpy(1_000_000 + np.arange(B) // LANES).to(dev)
    kw = dict(window=20, k=5, experts=("lru", "lfu"))
    args = (size, *meta, keys, cdf, must, torch.tensor(2, device=dev), ts)
    shapes[("ranked_eviction", B)] = (args, kw)
    offs, ech = ref.eviction_draw_ref(keys, cdf, ts, n)
    shapes[("ranked_eviction_given", B)] = (
        (size, *meta, offs, ech, must, args[-2], ts), kw)
    check_tenant_draw(dev, rng, size, meta, shapes)


def check_tenant_draw(dev, rng, size, meta, shapes: dict) -> None:
    """Phase 2: the draw form's tenant case (the multi-tenant step's,
    phase 9's) against its plain version on the full table: a tenant
    column over 4 tenants, a filter of -1 and tenant ids, each op's
    tenant picking its (lane, tenant) row of a [64, 4, E] cdf (every
    seventh lane's tenant-1 row below every draw: choice E), W = 128, K =
    5, 33 and 64, E = 2 and 5, B = 1, 63 and 2048; bit-equal, and each
    filtered op's victims of its own tenant.  Then phase 9's shape (B =
    2048, W = 128, K = 5, lru and lfu, per-op quotas) for the timing,
    beside the untenanted draw form at the same W on the same inputs."""
    import numpy as np
    import torch
    from repro_torch.core.cache import _expert_cdf
    from repro_torch.kernels import ops, ref

    n, Tn, W = size.shape[0], 4, 128
    tenant = torch.from_numpy(rng.integers(0, Tn, n)).to(dev)
    ten_np = tenant.cpu().numpy()

    def inputs(B, E, K):
        w = rng.random((LANES, Tn, E)).astype(np.float32) + 1e-4
        w[::7, 1] = 1e-32
        op_t = rng.integers(0, Tn, B)
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        return (t(rng.integers(0, 2**32, (LANES, 2), dtype=np.uint64)
                  .astype(np.int64)),
                _expert_cdf(torch.from_numpy(w)).to(dev),
                t(rng.random(B) < 0.8), t(rng.integers(0, 4 * K, B)),
                t(1_000_000 + np.arange(B) // LANES), t(op_t),
                t(np.where(rng.random(B) < 0.5, -1, op_t)))

    for B in (1, 63, 2048):
        for K in (5, 33, 64):
            for experts in (("lru", "lfu"), EXPERTS_ALL):
                keys, cdf, must, quota, ts, op_t, tf = inputs(
                    B, len(experts), K)
                args = (size, *meta, keys, cdf, must, quota, ts)
                kw = dict(window=W, k=K, experts=experts, tenant=tenant,
                          tfilt=tf, op_tenant=op_t)
                got = ops.ranked_eviction_draw_op(*args, **kw)
                want = ref.ranked_eviction_draw_ref(*args, **kw)
                tag = (f"ranked_eviction draw, tenants[B={B},W={W},K={K},"
                       f"E={len(experts)}]")
                for name, g, w in zip(("victims", "cand", "e_choice",
                                       "bmap"), got, want):
                    same_int(f"{tag}.{name}", g, w)
                v, f = got[0].cpu().numpy(), tf.cpu().numpy()
                for b in np.nonzero(f >= 0)[0]:
                    if not (ten_np[v[b][v[b] >= 0]] == f[b]).all():
                        raise AssertionError(f"{tag}: op {b} took another "
                                             "tenant's slot")
                if B == 2048 and not int((got[0] >= 0).sum()):
                    raise AssertionError(f"{tag}: no victim")
    log("ranked_eviction's draw form with tenants agrees with its plain "
        "version at B = 1, 63, 2048 x K = 5, 33, 64 x E = 2, 5, W = 128 "
        "(bit-equal; filtered ops take only their tenant's slots)")
    keys, cdf, must, quota, ts, op_t, tf = inputs(2048, 2, 5)
    kw = dict(window=W, k=5, experts=("lru", "lfu"))
    args = (size, *meta, keys, cdf, must, quota, ts)
    shapes[("ranked_eviction_tenant", 2048)] = (
        args, dict(kw, tenant=tenant, tfilt=tf, op_tenant=op_t))
    shapes[("ranked_eviction_w128", 2048)] = (
        args[:5] + (cdf[:, 0].contiguous(),) + args[6:], kw)


def same_bits(name, got, want) -> None:
    """Two f32 tensors equal bit for bit."""
    import torch
    same_int(name, got.view(torch.int32), want.view(torch.int32))


def padded(cols, W: int) -> tuple:
    """f32 copies of the table columns with W empty slots at the tail, the
    form the JAX package's ``sampled_eviction`` op takes."""
    import torch
    return tuple(torch.cat([c.float(), c.new_zeros(W, dtype=torch.float32)])
                 for c in cols)


def check_entry_point(dev, rng, t, meta, live, probe_keys,
                      results: dict) -> None:
    """Phase 2, continued: the three kernels that only the ``kernels.ops``
    entry point reaches, against their plain versions at B = 13, 64 and
    2048 on the same table; then the entry point's path, counted; then
    the kernels timed at B = 2048."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    n = t["size"].shape[0]
    cols = (t["size"], meta["ins"], meta["last"], meta["freq"])
    freq_f, last_f = meta["freq"].float(), meta["last"].float()
    on_card = lambda c: torch.tensor(c, dtype=torch.float32, device=dev)
    shapes = {}
    for B in (13, 64, 2048):
        keys = probe_keys(B)
        args, kw = (t["key"], t["size"], keys), dict(assoc=ASSOC)
        got = ops.bucket_lookup_op(*args, **kw)
        want = ref.bucket_lookup_ref(*args, **kw)
        same_int(f"bucket_lookup[B={B}].found", got[0], want[0])
        same_int(f"bucket_lookup[B={B}].slot", got[1], want[1])
        if not bool(got[0].any()):
            raise AssertionError(f"bucket_lookup[B={B}]: no key found")
        shapes[("bucket_lookup", B)] = (args, kw)

        # sampled_eviction: all five experts, W = 20 and 128, K = 5 and
        # samples wider than a warp (K = 33, 64), the clock as a number
        # and on the card, the last op's window in the empty tail.
        for W, K in ((128, 5), (132, 33), (128, 64), (20, 5)):
            offs = rng.integers(0, n, B)
            offs[-1] = n
            sargs = padded(cols, W) + (torch.from_numpy(offs).to(dev),
                                       torch.from_numpy(rng.integers(
                                           0, len(EXPERTS_ALL), B)).to(dev))
            kw = dict(window=W, k=K, experts=EXPERTS_ALL)
            for clock in (1_000_016.0, on_card(1_000_031.0)):
                got = ops.sampled_eviction_op(*sargs, clock, **kw)
                want = ref.sampled_eviction_ref(*sargs, clock, **kw)
                tag = f"sampled_eviction[B={B},W={W},K={K}]"
                same_int(f"{tag}.victim", got[0], want[0])
                same_int(f"{tag}.cand", got[1], want[1])
                if int(got[0][-1]) != -1 or bool((got[1][-1] != -1).any()):
                    raise AssertionError(f"{tag}: a window in the empty tail "
                                         "gave a victim")
                if int((got[0] >= 0).sum()) < B // 2:
                    raise AssertionError(f"{tag}: few victims")
            shapes[("sampled_eviction", B)] = (sargs + (clock,), kw)

        # metadata_update: duplicates, -1 no-ops, a slot past C, non-integer
        # deltas; two launches must give the same bits.
        slots = rng.choice(live, B).astype(np.int64)
        slots[rng.random(B) < 0.3] = -1
        slots[1:5] = live[0]
        slots[-1] = n + 7
        margs = (freq_f, last_f, torch.from_numpy(slots).to(dev),
                 torch.from_numpy(rng.random(B, np.float32) * 10).to(dev),
                 on_card(1_000_016.5))
        got = ops.metadata_update_op(*margs)
        again = ops.metadata_update_op(*margs[:4], 1_000_016.5)
        want = ref.metadata_update_ref(*margs)
        for i, name in enumerate(("freq", "last_ts")):
            same_bits(f"metadata_update[B={B}].{name}", got[i], want[i])
            same_bits(f"metadata_update[B={B}].{name} (second launch)",
                      again[i], got[i])
        if bool((got[0] == freq_f).all()):
            raise AssertionError("metadata_update changed nothing")
        shapes[("metadata_update", B)] = (margs, {})
    log("the entry point's three kernels agree with their plain versions at "
        "B = 13, 64 and 2048 (bit-equal; metadata_update the same bits on "
        "two launches)")
    check_bucket_cases(dev, rng)
    check_metadata_cases(dev, rng, freq_f, last_f)

    # The entry point's path: ENTRY_STEPS Get batches of 2048 keys, each
    # probed, its hits' frequency and timestamp updated at the step's clock
    # (FC-cache flushes of one access each), and a victim sampled for each
    # op from the updated columns.  Counted, then replayed through the plain
    # versions from the same start, which must give the same bits.
    B, W = 2048, 20
    steps = [(probe_keys(B), torch.from_numpy(rng.integers(0, n, B)).to(dev),
              torch.from_numpy(rng.integers(0, 2, B)).to(dev),
              float(1_000_100 + i)) for i in range(ENTRY_STEPS)]
    ones = torch.ones(B, dtype=torch.float32, device=dev)

    def drive(lookup, update, evict):
        f, l, outs = freq_f, last_f, []
        for keys, offs, ech, clock in steps:
            found, slot = lookup(t["key"], t["size"], keys, assoc=ASSOC)
            f, l = update(f, l, torch.where(found, slot, -1), ones, clock)
            victim, cand = evict(*padded((t["size"], meta["ins"], l, f), W),
                                 offs, ech, clock, window=W, k=5,
                                 experts=("lru", "lfu"))
            outs += [found, slot, victim, cand]
        return outs, f, l

    torch.cuda.synchronize()
    ops.reset_launches()
    outs, f, l = drive(ops.bucket_lookup_op, ops.metadata_update_op,
                       ops.sampled_eviction_op)
    counts = ops.launches()
    plain, pf, pl = drive(ref.bucket_lookup_ref, ref.metadata_update_ref,
                          ref.sampled_eviction_ref)
    for i, (g, w) in enumerate(zip(outs, plain)):
        same_int(f"entry point step {i // 4} output {i % 4}", g, w)
    same_bits("entry point freq", f, pf)
    same_bits("entry point last_ts", l, pl)
    hits = sum(int(o.sum()) for o in outs[0::4])
    if not 0 < hits < ENTRY_STEPS * B:
        raise AssertionError(f"entry point: {hits} hits")
    for name in ENTRY_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"entry point: {name} never launched")
        results.setdefault(name, {})["launches"] = counts[name]
    log(f"entry point: {ENTRY_STEPS} batches of {B} keys, {hits} hits, "
        f"launches { {k: counts[k] for k in ENTRY_KERNELS} }; equal to the "
        f"plain versions' run bit for bit")

    # Timing at B = 2048.  metadata_update's plain version syncs the host
    # once (the most entries on one slot), so it is timed from Python; the
    # kernel in place (the outputs are the inputs: no copy) on copies of
    # the columns, then its functional form, which writes fresh columns.
    torch.cuda.synchronize()
    from repro_torch.kernels.bucket_lookup import bucket_lookup
    from repro_torch.kernels.metadata_update import (TILE, metadata_update,
                                                     metadata_update_into)
    from repro_torch.kernels.sampled_eviction import sampled_eviction
    margs, _ = shapes[("metadata_update", 2048)]
    own = tuple(a.clone() for a in margs[:2])
    in_place = lambda *a: metadata_update_into(*own, *a[2:], *own)
    kern = {"sampled_eviction": (sampled_eviction, ref.sampled_eviction_ref),
            "bucket_lookup": (bucket_lookup, ref.bucket_lookup_ref),
            "metadata_update": (in_place, ref.metadata_update_ref)}
    for name, (k_fn, p_fn) in kern.items():
        args, kw = shapes[(name, 2048)]
        r = results[name]
        r["ms"] = time_ms(lambda: k_fn(*args, **kw))
        timer = eager_ms if name == "metadata_update" else time_ms
        r["plain_ms"] = timer(lambda: p_fn(*args, **kw))
        r["eager_ms"] = eager_ms(lambda: k_fn(*args, **kw))
        r["bytes"] = bound_bytes(name, args, kw)
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["max_abs_err"] = 0.0
        log(f"{name} at B=2048: {r['ms'] * 1e3:.2f} us a call on the "
            f"device ({r['eager_ms'] * 1e3:.2f} us launched from Python), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes']} bytes)")
    # The functional form: the kernel copies the two columns into fresh
    # outputs in the same launch.  Its bound adds the columns' copy (each
    # read once and written once); PyTorch's copy of them on its own beside.
    r = results["metadata_update"]
    r["copy_ms"] = time_ms(lambda: tuple(a.clone() for a in margs[:2]))
    r["copy_bound_ms"] = (2 * sum(a.numel() * a.element_size()
                                  for a in margs[:2]) / HBM_BYTES_PER_S * 1e3)
    r["wrapper_ms"] = time_ms(lambda: metadata_update(*margs))
    r["wrapper_bound_ms"] = r["copy_bound_ms"] + r["bound_ms"]
    log(f"metadata_update's functional form (fresh outputs, the copy in the "
        f"launch): {r['wrapper_ms'] * 1e3:.2f} us, bound "
        f"{r['wrapper_bound_ms'] * 1e3:.2f} us; PyTorch's copy of the two "
        f"columns alone {r['copy_ms'] * 1e3:.2f} us, bound "
        f"{r['copy_bound_ms'] * 1e3:.2f} us")
    # In place where slots repeat most or crowd one tile: every slot twice,
    # B / 2 entries apart; all on one slot (a chain of B adds); B distinct
    # slots of one tile (one CTA packs and combines them all).  Bit-equal
    # to the plain version.
    for tag, s in (("pairs", np.tile(rng.choice(live, B // 2), 2)),
                   ("one_slot", np.full(B, live[0])),
                   ("one_tile", md_slots(rng, "one_tile", B, n, TILE))):
        args = (margs[0], margs[1], torch.from_numpy(s).to(dev)) + margs[3:]
        got, want = metadata_update(*args), ref.metadata_update_ref(*args)
        for i, name in enumerate(("freq", "last_ts")):
            same_bits(f"metadata_update[{tag}].{name}", got[i], want[i])
        r[f"ms_{tag}"] = time_ms(lambda: in_place(*args))
    log(f"metadata_update in place with every slot twice, B / 2 apart: "
        f"{r['ms_pairs'] * 1e3:.2f} us; with all {B} on one slot: "
        f"{r['ms_one_slot'] * 1e3:.2f} us; {B} distinct slots of one tile: "
        f"{r['ms_one_tile'] * 1e3:.2f} us (bit-equal to the plain version)")
    # A large batch: every CTA reads all of it (from L2).
    B = 65_536
    s = rng.choice(live, B)
    s[rng.random(B) < 0.3] = -1
    args = (margs[0], margs[1], torch.from_numpy(s).to(dev),
            torch.from_numpy(rng.random(B, np.float32) * 10).to(dev),
            margs[4])
    got, want = metadata_update(*args), ref.metadata_update_ref(*args)
    for i, name in enumerate(("freq", "last_ts")):
        same_bits(f"metadata_update[B={B}].{name}", got[i], want[i])
    r["ms_65k"] = time_ms(lambda: in_place(*args))
    r["bound_ms_65k"] = (bound_bytes("metadata_update", args, {})
                         / HBM_BYTES_PER_S * 1e3)
    r["wrapper_ms_65k"] = time_ms(lambda: metadata_update(*args))
    r["wrapper_bound_ms_65k"] = r["copy_bound_ms"] + r["bound_ms_65k"]
    log(f"metadata_update at B={B}: in place {r['ms_65k'] * 1e3:.2f} us "
        f"(bound {r['bound_ms_65k'] * 1e3:.3f} us), functional "
        f"{r['wrapper_ms_65k'] * 1e3:.2f} us (bound "
        f"{r['wrapper_bound_ms_65k'] * 1e3:.2f} us)")


def md_slots(rng, case: str, B: int, C: int, tile: int):
    """metadata_update's slots i64[B] in one of MD_CASES on a C-slot
    table cut into tiles of ``tile`` slots."""
    import numpy as np
    lo = tile * ((C // tile) // 2)          # a tile in the middle
    span = min(tile, C - lo)
    if case == "one_slot":
        return np.full(B, lo + 5, np.int64)
    if case == "pairs":                     # every slot twice, B / 2 apart
        return np.tile(rng.choice(C, (B + 1) // 2, replace=False), 2)[:B]
    if case == "one_tile":                  # distinct while B fits the tile
        return lo + rng.choice(span, B, replace=B > span)
    if case == "tile_edges":                # both sides of every tile edge
        edges = np.arange(tile, C, tile)
        return rng.choice(np.concatenate([edges - 1, edges, [0, C - 1]]), B)
    s = rng.integers(0, C, B)
    if case == "no_ops":                    # -1 and slots past the table
        bad = rng.random(B) < 0.5
        s[bad] = rng.choice(np.array([-1, C, C + 7, 2**40]), int(bad.sum()))
    else:                                   # mixed: a bit of everything
        s = rng.integers(-1, C + 3, B)
        s[1:5] = s[0]
    return s


def check_bucket_cases(dev, rng) -> None:
    """bucket_lookup bit-equal to its plain version at every assoc of
    BL_ASSOCS (a 64-slot bucket in two 32-slot chunks) on a table whose
    last assoc - 1 slots are a ragged tail no bucket covers (live keys
    there must miss), at every B of BL_BATCHES; one launch a call."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    ops.reset_launches()
    calls = 0
    for assoc in BL_ASSOCS:
        tab = random_table(rng, max(64, 16384 // assoc), assoc, 1_000,
                           1 << 20)
        tail = assoc - 1
        key = np.concatenate([tab["key"], rng.integers(
            1, 2**32, tail, dtype=np.uint64).astype(np.int64)])
        size = np.concatenate([tab["size"], np.full(tail, 3)])
        held = np.nonzero(size > 0)[0]      # live, history and tail keys
        cols = (torch.from_numpy(key).to(dev), torch.from_numpy(size).to(dev))
        for B in BL_BATCHES:
            q = key[rng.choice(held, B)]
            miss = rng.random(B) < 0.3
            q[miss] = rng.integers(0, 2**32, int(miss.sum()),
                                   dtype=np.uint64).astype(np.int64)
            q[-1] = key[-1] if tail else q[-1]   # a key of the ragged tail
            keys = torch.from_numpy(q.astype(np.int64)).to(dev)
            got = ops.bucket_lookup_op(*cols, keys, assoc=assoc)
            want = ref.bucket_lookup_ref(*cols, keys, assoc=assoc)
            calls += 1
            tag = f"bucket_lookup[assoc={assoc},C={key.size},B={B}]"
            same_int(f"{tag}.found", got[0], want[0])
            same_int(f"{tag}.slot", got[1], want[1])
            if B > 1 and not bool(got[0].any()):
                raise AssertionError(f"{tag}: no key found")
    if ops.launches()["bucket_lookup"] != calls:
        raise AssertionError(f"bucket_lookup: {ops.launches()} for {calls} "
                             "calls")
    log(f"bucket_lookup agrees with its plain version at assoc "
        f"{', '.join(map(str, BL_ASSOCS))} (C not a multiple of assoc) x "
        f"B = {', '.join(map(str, BL_BATCHES))}: {calls} launches, bit-equal")


def check_metadata_cases(dev, rng, freq, last) -> None:
    """metadata_update bit-equal to its plain version in every case of
    MD_CASES at every B of MD_BATCHES, on the phase's table and on a
    prefix of it 5 slots shorter (C not a multiple of the kernel's tile,
    nor of the four floats of its 16-byte copy), with non-integer deltas
    and a NaN in last_ts at the batch's first and middle slots: into fresh
    outputs, in place (the outputs are the inputs' own storage), and a
    second launch the same bits; one launch a call."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.metadata_update import TILE, metadata_update_into

    ops.reset_launches()
    calls = 0
    clock = torch.tensor(1_000_016.5, dtype=torch.float32, device=dev)
    for C in (freq.shape[0], freq.shape[0] - 5):
        for B in MD_BATCHES:
            for case in MD_CASES:
                s = md_slots(rng, case, B, C, TILE)
                lt = last[:C].clone()
                nan = s[[0, B // 2]]
                lt[torch.from_numpy(nan[(nan >= 0) & (nan < C)]).to(dev)] = (
                    float("nan"))
                args = (freq[:C], lt, torch.from_numpy(s).to(dev),
                        torch.from_numpy(rng.random(B, np.float32) * 10)
                        .to(dev), clock)
                want = ref.metadata_update_ref(*args)
                got = ops.metadata_update_op(*args)
                again = ops.metadata_update_op(*args[:4], 1_000_016.5)
                own = (freq[:C].clone(), lt.clone())
                metadata_update_into(*own, *args[2:], *own)
                calls += 3
                tag = f"metadata_update[C={C},B={B},{case}]"
                for i, name in enumerate(("freq", "last_ts")):
                    same_bits(f"{tag}.{name}", got[i], want[i])
                    same_bits(f"{tag}.{name} (second launch)", again[i],
                              got[i])
                    same_bits(f"{tag}.{name} (in place)", own[i], want[i])
                if B > 1 and torch.equal(got[0], freq[:C]):
                    raise AssertionError(f"{tag}: nothing changed")
    if ops.launches()["metadata_update"] != calls:
        raise AssertionError(f"metadata_update: {ops.launches()} for {calls}"
                             " calls")
    log(f"metadata_update agrees with its plain version in the cases "
        f"{', '.join(MD_CASES)} x B = {', '.join(map(str, MD_BATCHES))} x C "
        f"= {freq.shape[0]} and {freq.shape[0] - 5} (fresh outputs, in "
        f"place, a second launch; a NaN in last_ts): {calls} launches, "
        f"bit-equal")


def bound_bytes(name: str, args, kw) -> int:
    """Bytes the function must move on these inputs: each input byte it
    needs read once, each output byte written once (int64 storage)."""
    import torch
    if name == "bucket_lookup":
        # The probed buckets' key and size words, the keys in, (found,
        # slot) out.
        tkey, tsize, keys = args
        from repro_torch.core.hashing import bucket_of, hash_key
        buckets = torch.unique(bucket_of(hash_key(keys),
                                         tkey.shape[0] // kw["assoc"]))
        B = keys.shape[0]
        return int(buckets.numel() * kw["assoc"] * 2 * 8 + B * 8
                   + B * (1 + 8))
    if name == "sampled_eviction":
        # f32 sizes up to each op's K-th live slot, three more columns at
        # each sampled slot, offsets, choices and the clock in; the victim
        # and E candidates out.
        size, ins, last, freq, offs, ech, clock = args
        W, K, E = kw["window"], kw["k"], len(kw["experts"])
        N, B = size.shape[0], offs.shape[0]
        idx = offs[:, None] + torch.arange(W, device=offs.device)[None, :]
        inside = (idx >= 0) & (idx < N)
        s = torch.where(inside, size[idx.clamp(0, N - 1)], 0.0)
        live = (s > 0) & (s < 255)
        cum = torch.cumsum(live.to(torch.int64), dim=1)
        n_scan = torch.unique(idx[inside & ((cum - live.to(torch.int64))
                                            < K)]).numel()
        n_samp = torch.unique(idx[live & (cum <= K)]).numel()
        return int(n_scan * 4 + n_samp * 3 * 4 + B * (8 + 8) + 4
                   + B * (1 + E) * 8)
    if name == "metadata_update":
        # The passes alone: slots and deltas in; at each distinct touched
        # slot freq and last_ts in and out.
        freq, last, slots, deltas, _ = args
        ok = (slots >= 0) & (slots < freq.shape[0])
        touched = torch.unique(slots[ok]).numel()
        return int(slots.numel() * 8 + deltas.numel() * 4 + 4
                   + touched * (4 + 4) * 2)
    if name == "access_probe":
        # The probed buckets' key, size, hash and ptr words (and with the
        # facts insert_ts, last_ts and freq), the keys (and timestamps) in;
        # (found, slot, hist_found, hist_slot) (and the facts) out.
        tkey, tsize, thash, tptr, keys, _ = args
        assoc = kw["assoc"]
        from repro_torch.core.hashing import bucket_of, hash_key
        buckets = torch.unique(bucket_of(hash_key(keys), tkey.shape[0] // assoc))
        B = keys.shape[0]
        facts = "meta" in kw
        E = len(kw["experts"]) if facts else 0
        return int(buckets.numel() * assoc * (7 if facts else 4) * 8
                   + B * (16 if facts else 8) + 8 + B * (1 + 8 + 1 + 8)
                   + (B * (8 * 4 + 3 + (E + 1) * 8) if facts else 0))
    if name == "drop_scatter":
        # Each group's indices (and mask) in; at each kept entry the
        # source words it takes in (a select's flag, and the part it
        # picks when that is a tensor; a number reads nothing) and its
        # destination rows out.
        total = 0
        for group in args[0]:
            idx, cols, srcs, mask = (*group, None)[:4]
            keep = (idx >= 0) & (idx < cols[0].shape[0])
            if mask is not None:
                keep = keep & mask
                total += mask.numel()
            total += idx.numel() * 8
            for c, x in zip(cols, srcs):
                row = c[0].numel() * c.element_size()
                total += int(keep.sum()) * row
                cond, a, b = x if isinstance(x, tuple) else (None, x, 0)
                pick = keep if cond is None else keep & cond
                total += int(pick.sum()) * row * torch.is_tensor(a)
                if cond is not None:
                    total += int(keep.sum())
                    total += int((keep & ~cond).sum()) * row * torch.is_tensor(b)
        return total
    if name == "hit_metadata_update":
        # In place: the hit and emit arrays in; at each distinct hit slot
        # its step-entry freq, last_ts and ext in and last_ts, ext out; at
        # each distinct flush slot freq in and out.
        freq, last, ext, hit, hts, emit, delta = args
        hs = torch.unique(hit[hit >= 0]).numel()
        es = torch.unique(emit[emit >= 0]).numel()
        return int((hit.numel() + hts.numel() + emit.numel()
                    + delta.numel()) * 8 + hs * (8 + 8 + 16) + hs * (8 + 16)
                   + es * (8 + 8))
    if name == "ranked_eviction_tenant":
        # The draw form's tenant case: each slot scanned also reads its
        # tenant word, each op its tenant id and filter, and the cdf is a
        # row per (lane, tenant).
        from repro_torch.kernels import ref
        size, ins, last, freq, keys, cdf, must, quota, ts = args
        tenant, tf, op_t = kw["tenant"], kw["tfilt"], kw["op_tenant"]
        W, K, E = kw["window"], kw["k"], len(kw["experts"])
        C, B = size.shape[0], ts.shape[0]
        offs, _ = ref.eviction_draw_ref(keys, cdf, ts, C, op_t)
        idx = (offs[:, None] + torch.arange(W, device=offs.device)[None, :]
               ) % C
        s = size[idx]
        elig = ((s > 0) & (s < 255)
                & ((tf[:, None] < 0) | (tenant[idx] == tf[:, None])))
        cum = torch.cumsum(elig.to(torch.int64), dim=1)
        scanned = (cum - elig.to(torch.int64)) < K
        n_scan = torch.unique(idx[scanned]).numel()
        n_samp = torch.unique(idx[elig & (cum <= K)]).numel()
        return int(n_scan * 2 * 8 + n_samp * 3 * 8
                   + B * (8 + 1 + 8 + 8 + 8) + keys.numel() * 8
                   + cdf.numel() * 4 + B * (2 * K + E + 1) * 8)
    # ranked_eviction, given each op's offset and choice or drawing them.
    if name == "ranked_eviction":
        # The draw form: instead of offsets and choices, each lane's key
        # (16 B) and cdf row (4E B) in, the choice and the victims'
        # bitmaps out.
        from repro_torch.kernels import ref
        size, ins, last, freq, keys, cdf, must, quota, ts = args
        offs, ech = ref.eviction_draw_ref(keys, cdf, ts, size.shape[0])
        K = kw["k"]
        B = ts.shape[0]
        return (bound_bytes("ranked_eviction_given", (
            size, ins, last, freq, offs, ech, must, quota, ts), kw)
            - B * (8 + 8) + keys.numel() * 8 + cdf.numel() * 4
            + B * (8 + K * 8))
    size, ins, last, freq, offs, ech, must, quota, ts = args
    W, K = kw["window"], kw["k"]
    E = len(kw["experts"])
    C = size.shape[0]
    B = offs.shape[0]
    idx = (offs[:, None] + torch.arange(W, device=offs.device)[None, :]) % C
    s = size[idx]
    elig = (s > 0) & (s < 255)
    cum = torch.cumsum(elig.to(torch.int64), dim=1)
    # Window slots up to the K-th eligible one (size column), and the
    # metadata of each sampled slot.
    scanned = (cum - elig.to(torch.int64)) < K
    sampled = elig & (cum <= K)
    n_scan = torch.unique(idx[scanned]).numel()
    n_samp = torch.unique(idx[sampled]).numel()
    return int(n_scan * 8 + n_samp * 3 * 8 + B * (8 + 8 + 1 + 8)
               + quota.numel() * 8 + B * (K + E) * 8)


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path, both backends, bit-compared.
# ---------------------------------------------------------------------------

def compare_runs(tag: str, a, b) -> None:
    """Fused vs reference ExecResults: integers bit-equal, f32 <= 4 ulp."""
    import numpy as np
    if not np.array_equal(a.hits, b.hits):
        raise AssertionError(f"{tag}: per-round hits differ")
    if not np.array_equal(a.ops, b.ops):
        raise AssertionError(f"{tag}: per-round ops differ")
    same_parts(tag, (a.state, a.clients, a.stats),
               (b.state, b.clients, b.stats), 4)
    d = ulp_diff(a.weights, b.weights)
    if d > 4:
        raise AssertionError(f"{tag}: weight trajectories {d} ulp apart")


def check_state(tag: str, res) -> None:
    """The cache's own invariants on the state a run produced."""
    import torch
    st = res.state
    live = (st.size != 0) & (st.size != 255)
    if int(st.n_cached) != int(live.sum()):
        raise AssertionError(f"{tag}: n_cached != live slots")
    if int(st.bytes_cached) != int(torch.where(live, st.size, 0).sum()):
        raise AssertionError(f"{tag}: bytes_cached != sum of live sizes")
    w = st.weights
    if not bool(torch.isfinite(w).all()) or abs(float(w.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"{tag}: expert weights {w.tolist()}")
    if not 0.0 < res.hit_rate < 1.0:
        raise AssertionError(f"{tag}: hit ratio {res.hit_rate}")


def cache_launches() -> dict:
    """The device launch counts of the cache step's four kernels."""
    from repro_torch.kernels import ops
    n = ops.launches()
    return {k: n[k] for k in CACHE_KERNELS}


def plan_trace(n_requests: int, seq_rounds: int) -> tuple:
    """Phases 3-5's YCSB-A trace over LANES lanes, and the lane plan of
    its first n_requests (phase 3's): (keys, is_write, rows planned,
    plan, plan_s)."""
    from repro_torch.workloads.gen import interleave, ycsb
    from repro_torch.workloads.plan import pack_rows
    t0 = time.perf_counter()
    keys, wr = ycsb("A", n_requests + (seq_rounds + ADAPTIVE_ROWS) * LANES,
                    n_keys=N_KEYS, seed=SEED)
    k2, w2 = interleave(keys, LANES, wr)
    T = n_requests // LANES
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = pack_rows(k2[:T], N_BUCKETS, BATCH, is_write=w2[:T])
    plan_s = time.perf_counter() - t0
    log(f"trace: {T * LANES} requests over {N_KEYS} keys, {LANES} lanes; "
        f"gen {gen_s:.1f} s; lane plan at batch {BATCH}: {gp.n_groups} "
        f"groups, fill {gp.fill:.3f}, plan_s {plan_s:.2f}")
    return k2, w2, T, gp, plan_s


def run_main_path(dev, card: str, n_requests: int, seq_rounds: int,
                  results: dict) -> tuple:
    """Phases 3 and 4; returns the run's numbers, the plan and the
    trace it executed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import CacheConfig, execute, make
    from repro_torch.core.types import hit_ratio
    from repro_torch.kernels import ops

    k2, w2, T, gp, plan_s = plan_trace(n_requests, seq_rounds)
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY,
                      backend="fused")
    out = dict(requests=int(gp.n_scheduled), groups=gp.n_groups,
               fill=gp.fill, plan_s=plan_s)
    res = {}
    for backend in ("fused", "reference"):
        c = make(dataclasses.replace(cfg, backend=backend), LANES, SEED,
                 device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        r = execute(c, k2[:T], plan=gp, is_write=w2[:T])
        launches = cache_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        n = int(r.ops.sum())
        log(f"[{card}] grouped {backend}: {n} requests in {r.wall_s:.2f} s "
            f"= {n / r.wall_s:.0f} requests/s, "
            f"{r.wall_s * 1e6 / gp.n_groups:.0f} us/step, "
            f"hit ratio {hit_ratio(r.stats):.4f}, evictions "
            f"{int(r.stats.evictions)}, peak {peak / 2**20:.0f} MiB, "
            f"launches {launches}")
        check_state(f"grouped/{backend}", r)
        res[backend] = r
        out[backend] = dict(wall_s=r.wall_s, requests_per_s=n / r.wall_s,
                            us_per_step=r.wall_s * 1e6 / gp.n_groups,
                            hit_ratio=hit_ratio(r.stats),
                            evictions=int(r.stats.evictions),
                            peak_mib=peak / 2**20, launches=launches)
    compare_runs("grouped", res["fused"], res["reference"])
    out["step_ops"] = check_step_traffic(dev, cfg, gp)
    launches = out["fused"]["launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    # One launch of each kernel a step: the probe (with the insert path's
    # facts) once, the apply's three write groups in one drop_scatter.
    if len(set(launches.values())) != 1:
        raise AssertionError(f"the fused step's kernels launched unequally: "
                             f"{launches}")
    if out["reference"]["launches"] != {k: 0 for k in launches}:
        raise AssertionError("the reference backend launched a kernel")
    for name, n in launches.items():
        results[name]["launches"] = n
    log("grouped: fused == reference (integers bit-equal, f32 <= 4 ulp)")

    # Sequential rounds from the warmed caches.
    seq = {}
    ks, ws = k2[T:T + seq_rounds], w2[T:T + seq_rounds]
    for backend in ("fused", "reference"):
        ops.reset_launches()
        r = execute(res[backend].cache, ks, plan=None, is_write=ws)
        launches = cache_launches()
        n = int(r.ops.sum())
        log(f"[{card}] sequential {backend}: {n} requests in {r.wall_s:.2f} "
            f"s = {n / r.wall_s:.0f} requests/s, "
            f"{r.wall_s * 1e6 / seq_rounds:.0f} us/step, launches {launches}")
        check_state(f"sequential/{backend}", r)
        seq[backend] = r
        out[f"seq_{backend}"] = dict(
            wall_s=r.wall_s, requests_per_s=n / r.wall_s,
            us_per_step=r.wall_s * 1e6 / seq_rounds, launches=launches)
    compare_runs("sequential", seq["fused"], seq["reference"])
    if min(out["seq_fused"]["launches"].values()) <= 0:
        raise AssertionError("a kernel never launched on the sequential path")
    log("sequential: fused == reference (integers bit-equal, f32 <= 4 ulp)")

    # The default plan ("adaptive") from the caches the sequential rounds
    # left: a width per window, one captured graph per width.
    ada = {}
    lo = T + seq_rounds
    ka, wa = k2[lo:lo + ADAPTIVE_ROWS], w2[lo:lo + ADAPTIVE_ROWS]
    for backend in ("fused", "reference"):
        ops.reset_launches()
        r = execute(seq[backend].cache, ka, is_write=wa)
        launches = cache_launches()
        n = int(r.ops.sum())
        widths = sorted({w["width"] for w in r.windows})
        steps = sum(w["n_steps"] for w in r.windows)
        first = sum(w["wall_s"] for w in r.windows if w["compiled"])
        log(f"[{card}] adaptive {backend}: {n} requests in {r.wall_s:.2f} s "
            f"= {n / r.wall_s:.0f} requests/s, {steps} steps, plan_s "
            f"{r.plan_s:.2f}, {len(r.windows)} segments of widths {widths}, "
            f"{sum(w['compiled'] for w in r.windows)} of them first at their "
            f"width ({first:.2f} s, warm-up and capture included), "
            f"launches {launches}")
        check_state(f"adaptive/{backend}", r)
        ada[backend] = r
        out[f"adaptive_{backend}"] = dict(
            wall_s=r.wall_s, requests_per_s=n / r.wall_s, steps=steps,
            plan_s=r.plan_s, segments=len(r.windows), widths=widths,
            first_segments_s=first, launches=launches)
    compare_runs("adaptive", ada["fused"], ada["reference"])
    if min(out["adaptive_fused"]["launches"].values()) <= 0:
        raise AssertionError("a kernel never launched on the adaptive path")
    log("adaptive: fused == reference (integers bit-equal, f32 <= 4 ulp)")
    if out["fused"]["evictions"] <= 0:
        raise AssertionError("the grouped run evicted nothing")
    return out, gp, k2[:T]


# ---------------------------------------------------------------------------
# Phases 9 and 10: the multi-tenant pool and the L0 near-cache.
# ---------------------------------------------------------------------------

def fused_and_reference(tag: str, runs: dict) -> None:
    """Phase 9's and 10's runs, fused against reference: per-round (and
    lane) hits and ops, and integer state bit-equal; ext and gds_L within
    4 ulp, the compounded weight columns within 16."""
    import numpy as np
    a, b = runs["fused"], runs["reference"]
    for name in ("hits", "ops"):
        if not np.array_equal(a[name], b[name]):
            raise AssertionError(f"{tag}: per-round {name} differ")
    same_parts(tag, a["parts"], b["parts"], 4, weight_ulp=16)
    d = ulp_diff(a["weights"], b["weights"])
    if d > 16:
        raise AssertionError(f"{tag}: weight trajectories {d} ulp apart")


def tenant_occupancy(st, Tn: int):
    """Each tenant's live blocks, recomputed on the card from the table
    (T masked sums)."""
    import torch
    live = (st.size != 0) & (st.size != 255)
    return torch.stack([torch.where(live & (st.tenant == t), st.size, 0)
                        .sum() for t in range(Tn)])


def live_keys(st, Tn: int) -> list:
    """Each tenant's live keys, on the host (sorted)."""
    import numpy as np
    key, size, ten = (x.cpu().numpy() for x in (st.key, st.size, st.tenant))
    live = (size != 0) & (size != 255)
    return [np.unique(key[live & (ten == t)]) for t in range(Tn)]


def run_tenants(dev, card: str, results: dict, profile: int = 0,
                out_dir: Path | None = None) -> dict:
    """Phase 9: the three-tenant mix through execute() in CHUNKS chunks on
    both backends, checked at every chunk's end and against each other;
    ``profile``: then trace that many of the first chunk's steps (and
    twice as many) per backend."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import CacheConfig, execute, make
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import tenant_mix
    from repro_torch.workloads.plan import pack_rows

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    keys, ten, sizes = tenant_mix(MIX_REQUESTS, LANES, TENANT_SPECS,
                                  seed=11, key_stride=1 << 23)
    gen_s = time.perf_counter() - t0
    T, Tn = keys.shape[0], len(TENANT_SPECS)
    edges = np.linspace(0, T, CHUNKS + 1).astype(int)
    t0 = time.perf_counter()
    plans = [pack_rows(keys[a:b], N_BUCKETS, BATCH, sizes=sizes[a:b],
                       tenants=ten[a:b]) for a, b in zip(edges, edges[1:])]
    plan_s = time.perf_counter() - t0
    n_groups = sum(gp.n_groups for gp in plans)
    lane_tenant = ten[0]
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY,
                      n_tenants=Tn, sample_window=128, sync_period=50)
    budget = torch.tensor(cfg.tenant_budgets, device=dev)
    log(f"phase 9: tenant_mix of {T * LANES} requests, {LANES} lanes "
        f"(tenants' lanes {[int((lane_tenant == t).sum()) for t in range(Tn)]}"
        f"), gen {gen_s:.1f} s; {CHUNKS} chunks planned at batch {BATCH} "
        f"into {n_groups} groups in {plan_s:.1f} s; budgets "
        f"{list(cfg.tenant_budgets)} blocks")
    runs, out = {}, dict(requests=int(T * LANES), groups=n_groups)
    for backend in ("fused", "reference"):
        c = make(dataclasses.replace(cfg, backend=backend), LANES, SEED,
                 device=dev)
        ops.reset_launches()
        wall, hits, opsl, ws = 0.0, [], [], []
        peak = torch.zeros(Tn, dtype=torch.int64, device=dev)
        removed, prev = np.zeros(Tn, np.int64), None
        for gp, a, b in zip(plans, edges, edges[1:]):
            r = execute(c, keys[a:b], plan=gp, sizes=sizes[a:b],
                        tenants=ten[a:b], by_lane=True)
            c, wall = r.cache, wall + r.wall_s
            hits.append(r.hits)
            opsl.append(r.ops)
            ws.append(r.weights)
            st = c.state
            if not torch.equal(tenant_occupancy(st, Tn), st.tenant_bytes):
                raise AssertionError(f"phase 9 {backend}: tenant_bytes "
                                     f"{st.tenant_bytes.tolist()} is not the "
                                     "table's live blocks per tenant")
            if bool((st.tenant_bytes > budget).any()):
                raise AssertionError(f"phase 9 {backend}: a tenant above its "
                                     f"budget: {st.tenant_bytes.tolist()}")
            peak = torch.maximum(peak, st.tenant_bytes)
            if backend == "fused":
                now = live_keys(st, Tn)
                if prev is not None:
                    removed += [np.setdiff1d(p, q, assume_unique=True).size
                                for p, q in zip(prev, now)]
                prev = now
        launches = cache_launches()
        hits, opsl = np.concatenate(hits), np.concatenate(opsl)
        runs[backend] = dict(hits=hits, ops=opsl, weights=np.concatenate(ws),
                             parts=(c.state, c.clients, c.stats))
        s = c.stats
        n = int(opsl.sum())
        per_t = [float(hits[:, lane_tenant == t].sum()
                       / max(opsl[:, lane_tenant == t].sum(), 1))
                 for t in range(Tn)]
        out[backend] = dict(
            wall_s=wall, requests_per_s=n / wall, us_per_step=wall * 1e6
            / n_groups, hit_ratio=float(hits.sum() / max(n, 1)),
            hit_ratio_by_tenant=per_t, evictions=int(s.evictions),
            insert_drops=int(s.insert_drops), launches=launches,
            peak_blocks=peak.tolist())
        log(f"[{card}] phase 9 {backend}: {n} requests in {wall:.2f} s = "
            f"{n / wall:.0f} requests/s, {wall * 1e6 / n_groups:.0f} us/step, "
            f"hit ratio {out[backend]['hit_ratio']:.4f}, by tenant "
            f"{[round(h, 4) for h in per_t]}, evictions {int(s.evictions)}, "
            f"insert_drops {int(s.insert_drops)}, tenant_bytes "
            f"{c.state.tenant_bytes.tolist()}, peak {peak.tolist()}, "
            f"launches {launches}")
        if backend == "fused":
            out["removed_by_tenant"] = removed.tolist()
            if len(set(launches.values())) != 1 or min(
                    launches.values()) < n_groups:
                raise AssertionError(f"phase 9: not one launch of each "
                                     f"kernel a step: {launches}")
            results["ranked_eviction"]["launches_tenants"] = launches[
                "ranked_eviction"]
            # The final table's per-tenant live blocks, recomputed on the
            # host.
            size = c.state.size.cpu().numpy()
            tcol = c.state.tenant.cpu().numpy()
            live = (size != 0) & (size != 255)
            host = [int(size[live & (tcol == t)].sum()) for t in range(Tn)]
            if host != c.state.tenant_bytes.tolist():
                raise AssertionError("phase 9: tenant_bytes differs from the "
                                     f"host recompute {host}")
            if not (removed > 0).all():
                raise AssertionError(f"phase 9: a tenant never lost a live "
                                     f"object: {removed.tolist()}")
            flash = Tn - 1
            if int(peak[flash]) < 0.9 * cfg.tenant_budgets[flash]:
                raise AssertionError(f"phase 9: the flash tenant peaked at "
                                     f"{int(peak[flash])} blocks")
        elif launches != {k: 0 for k in launches}:
            raise AssertionError("phase 9: the reference backend launched a "
                                 "kernel")
    fused_and_reference("phase 9", runs)
    out["step_ops"] = check_step_traffic(dev, cfg, plans[0],
                                         tag=" (phase 9's config)")
    if profile:
        profile_steps(dev, card, plans[0], keys[:edges[1]], profile, out_dir,
                      cfg, "_tenants")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 9: fused == reference (integers bit-equal, weights <= 16 "
        f"ulp); no tenant above its budget and tenant_bytes exact at every "
        f"chunk; live objects lost by tenant {out['removed_by_tenant']}; "
        f"phase wall {out['wall_s']:.1f} s")
    return out


def run_l0(dev, card: str, results: dict, profile: int = 0,
           out_dir: Path | None = None) -> dict:
    """Phase 10: YCSB-B through execute() with the L0 tier on both
    backends and without it (the control), on one lane plan;
    ``profile``: then trace that many of its steps (and twice as many)
    per backend."""
    import dataclasses
    from repro_torch.core import CacheConfig, execute, make
    from repro_torch.core.types import hit_ratio
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import interleave, ycsb
    from repro_torch.workloads.plan import pack_rows

    t_phase = time.perf_counter()
    keys, wr = ycsb("B", MIX_REQUESTS, n_keys=N_KEYS, seed=SEED)
    k2, w2 = interleave(keys, LANES, wr)
    gp = pack_rows(k2, N_BUCKETS, BATCH, is_write=w2)
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY,
                      l0_entries=L0_ENTRIES)
    log(f"phase 10: YCSB-B, {k2.size} requests over {N_KEYS} keys, "
        f"{LANES} lanes, {gp.n_groups} groups at batch {BATCH}, "
        f"l0_entries={L0_ENTRIES}")
    runs, out = {}, dict(requests=int(k2.size), groups=gp.n_groups)
    for name, c in (("fused", cfg),
                    ("reference", dataclasses.replace(cfg,
                                                      backend="reference")),
                    ("control", dataclasses.replace(cfg, l0_entries=0))):
        ops.reset_launches()
        r = execute(make(c, LANES, SEED, device=dev), k2, plan=gp,
                    is_write=w2)
        launches = cache_launches()
        s = r.stats
        n = int(r.ops.sum())
        out[name] = dict(
            wall_s=r.wall_s, requests_per_s=n / r.wall_s,
            us_per_step=r.wall_s * 1e6 / gp.n_groups,
            hit_ratio=hit_ratio(s), l0_hits=int(s.l0_hits),
            l0_invalidations=int(s.l0_invalidations),
            l0_hit_share=int(s.l0_hits) / max(int(s.gets), 1),
            rdma_read_bytes=int(s.rdma_read_bytes),
            evictions=int(s.evictions), launches=launches)
        log(f"[{card}] phase 10 {name}: {n} requests in {r.wall_s:.2f} s = "
            f"{n / r.wall_s:.0f} requests/s, "
            f"{r.wall_s * 1e6 / gp.n_groups:.0f} us/step, hit ratio "
            f"{hit_ratio(s):.4f}, L0 hits {int(s.l0_hits)} (share of gets "
            f"{out[name]['l0_hit_share']:.4f}), L0 invalidations "
            f"{int(s.l0_invalidations)}, rdma_read_bytes "
            f"{int(s.rdma_read_bytes)}, evictions {int(s.evictions)}, "
            f"launches {launches}")
        runs[name] = dict(hits=r.hits, ops=r.ops, weights=r.weights,
                          parts=(r.state, r.clients, r.stats))
        if name != "reference" and (len(set(launches.values())) != 1 or min(
                launches.values()) < gp.n_groups):
            raise AssertionError(f"phase 10 {name}: not one launch of each "
                                 f"kernel a step: {launches}")
        if name == "fused":
            results["ranked_eviction"]["launches_l0"] = launches[
                "ranked_eviction"]
    fused_and_reference("phase 10", runs)
    f, ctl = out["fused"], out["control"]
    if not (f["l0_hits"] > 0 and f["l0_invalidations"] > 0):
        raise AssertionError("phase 10: no L0 hit or no invalidation")
    if not f["rdma_read_bytes"] < ctl["rdma_read_bytes"]:
        raise AssertionError("phase 10: the L0 tier read no fewer bytes")
    if abs(f["hit_ratio"] - ctl["hit_ratio"]) >= 0.01:
        raise AssertionError(f"phase 10: hit ratio {f['hit_ratio']:.4f} is "
                             f"1 pp or more from the control's "
                             f"{ctl['hit_ratio']:.4f}")
    out["step_ops"] = check_step_traffic(dev, cfg, gp,
                                         tag=" (phase 10's config)")
    if profile:
        profile_steps(dev, card, gp, k2, profile, out_dir, cfg, "_l0")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 10: fused == reference (the L0 arrays and bucket_ver "
        f"included); L0 hit share {f['l0_hit_share']:.4f}; read bytes "
        f"{f['rdma_read_bytes']} vs the control's {ctl['rdma_read_bytes']} "
        f"({f['rdma_read_bytes'] / ctl['rdma_read_bytes']:.4f}); hit ratio "
        f"{f['hit_ratio']:.4f} vs {ctl['hit_ratio']:.4f}; phase wall "
        f"{out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 11 and 12: the DM pool and the failover leg.
# ---------------------------------------------------------------------------

def dm_parts(cl) -> tuple:
    return (cl.dm.state, cl.dm.clients, cl.dm.stats)


def dm_inputs(k2, w2, n_groups: int, G: int, dev) -> tuple:
    """The first n_groups * G rounds of a [T, S*lanes] trace as
    [n_groups, G, S*lanes] tensors on the card."""
    import numpy as np
    import torch
    k = k2[:n_groups * G].reshape(n_groups, G, -1).astype(np.int64)
    w = w2[:n_groups * G].reshape(n_groups, G, -1)
    return (torch.as_tensor(k, device=dev), torch.as_tensor(w, device=dev))


def dm_step_ops(dev, cl, keys, wr) -> dict:
    """The operators of one eager DM step (the group ``keys`` [G, S*lanes]
    routed and exchanged first, outside the count): all of them, and
    those that may launch device work (no allocation or view)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.dm import sharded_cache as sc

    S, L = cl.n_shards, cl.lanes_per_shard
    q = sc._route_capacity(L, S, DM_ROUTE)
    member = cl.membership()
    split = lambda x: x.reshape(1, keys.shape[0], S, L)
    rt = sc._route(S, L, q, cl.cfg.n_buckets, split(keys), split(wr),
                   split(torch.ones_like(keys)), split(torch.zeros_like(keys)),
                   member)
    recv, _, _ = sc._exchange(rt, member.serving)
    xs = tuple(x[0] for x in recv)
    step = sc._dm_step(cl.local, S, L, q)
    pad = sc._padded_rng(cl.dm.clients, S, L, S * q)
    carry = lambda: (cl.dm.state._replace(**{
        f: getattr(cl.dm.state, f).clone() for f in sc.SLOT_COLUMNS}),
        cl.dm.clients, cl.dm.stats, pad)
    step(carry(), xs)                          # warm
    called = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            called.append(str(func))
            return func(*args, **(kwargs or {}))

    c = carry()
    with Watch():
        step(c, xs)
    work = [o for o in called if not any(k in o for k in NO_KERNEL)]
    return dict(operators=len(called), device_ops=len(work))


def profile_dm(dev, card: str, cfg, k3, w3, n_groups: int,
               out_dir: Path | None) -> None:
    """Trace n_groups fused DM steps, and twice as many, with
    torch.profiler (each window one ``Cluster.execute`` from a fresh
    cluster: routing of its groups, the carry's copy into the graph and
    out, and the replays); the difference is the step alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dm import Cluster

    def run(k):
        cl = Cluster.make(cfg, DM_SHARDS, DM_LANES, SEED, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cl.execute(k3[:k], w3[:k], route_factor=DM_ROUTE)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    run(n_groups)                              # capture + allocator warm
    cats = []
    for k in (n_groups, 2 * n_groups):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run(k)
        cats.append(report_profile(prof, card, "dm_fused", k, wall,
                                   out_dir if k == n_groups else None))
    step = {kind: (t - cats[0].get(kind, 0.0)) / n_groups
            for kind, t in cats[1].items()}
    n_kernels = step.pop("kernels")
    log(f"    the DM step alone ({2 * n_groups} less {n_groups} steps), "
        f"device {sum(step.values()):.0f} us/step in {n_kernels:.0f} "
        f"kernels/step; by kind, us/step: "
        + ", ".join(f"{c} {t:.1f}" for c, t in
                    sorted(step.items(), key=lambda x: -x[1])))


def dm_cold_warm(dev, card: str, tag: str = "") -> list:
    """``--dm-only``: phase 11's fused run from a fresh cluster twice in
    this process: cold (the first run: the DM step's graph captured, the
    process's first kernel calls) and warm.  Each logs its µs a step
    (wall), the graph's capture time, the host's time in the replays
    (they block once the launch queue is full, so at the device's pace)
    and the device time a step of every 512 replays (CUDA events)."""
    import torch
    from repro_torch.core import CacheConfig
    from repro_torch.core import cache as core_cache
    from repro_torch.dm import Cluster
    from repro_torch.workloads.gen import interleave, ycsb

    keys, wr = ycsb("A", DM_REQUESTS, n_keys=N_KEYS, seed=SEED)
    k2, w2 = interleave(keys, DM_SHARDS * DM_LANES, wr)
    NG = k2.shape[0] // BATCH
    k3, w3 = dm_inputs(k2, w2, NG, BATCH, dev)
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY)
    acc = dict(replay=0.0, n=0, capture=0.0)
    marks = []
    replay, capture = torch.cuda.CUDAGraph.replay, core_cache.capture_graph

    def timed_replay(graph):
        if acc["n"] % 512 == 0:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        t0 = time.perf_counter()
        replay(graph)
        acc["replay"] += time.perf_counter() - t0
        acc["n"] += 1

    def timed_capture(fn, pool=None, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = capture(fn, pool, **kw)
        torch.cuda.synchronize(dev)
        acc["capture"] += time.perf_counter() - t0
        return out

    torch.cuda.CUDAGraph.replay = timed_replay
    core_cache.capture_graph = timed_capture
    out = []
    try:
        for run in ("cold", "warm"):
            cl = Cluster.make(cfg, DM_SHARDS, DM_LANES, SEED, device=dev)
            acc.update(replay=0.0, n=0, capture=0.0)
            marks.clear()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            cl.execute(k3, w3, route_factor=DM_ROUTE)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            dev_ms = [a.elapsed_time(b) / 512 for a, b in zip(marks,
                                                               marks[1:-1])]
            r = dict(run=run, us_per_step=wall * 1e6 / NG,
                     capture_s=acc["capture"],
                     replay_us=acc["replay"] * 1e6 / max(acc["n"], 1),
                     device_ms_per_512=dev_ms)
            out.append(r)
            log(f"[{card}] {tag}phase 11 fused {run}: "
                f"{r['us_per_step']:.0f} us/step, capture "
                f"{r['capture_s']:.2f} s, host in replay() "
                f"{r['replay_us']:.0f} us each x {acc['n']}, device ms a "
                f"step by 512 replays {[round(x, 3) for x in dev_ms]}")
    finally:
        torch.cuda.CUDAGraph.replay = replay
        core_cache.capture_graph = capture
    return out


def run_dm(dev, card: str, results: dict, profile: int = 0,
           out_dir: Path | None = None, keep: dict | None = None) -> tuple:
    """Phase 11: YCSB-A through ``Cluster.execute`` on an 8 x 8 cluster
    of phase 3's table, both backends, then the sanitize-armed re-run of
    its first groups; ``profile``: then trace that many fused DM steps
    (and twice as many).  Returns (the phase's numbers, the fused run's
    final cluster and its YCSB-A keys), phase 13's start; ``keep``
    receives the fused run's hits and its [NG, G, 64] inputs (phase
    18's)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import CacheConfig
    from repro_torch.core import cache as core_cache
    from repro_torch.core.types import hit_ratio
    from repro_torch.dm import Cluster
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import interleave, ycsb

    t_phase = time.perf_counter()
    S = DM_SHARDS
    keys, wr = ycsb("A", DM_REQUESTS, n_keys=N_KEYS, seed=SEED)
    k2, w2 = interleave(keys, S * DM_LANES, wr)
    NG = k2.shape[0] // BATCH
    k3, w3 = dm_inputs(k2, w2, NG, BATCH, dev)
    issued = int((k3 != 0).sum())
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY)
    q = min(DM_LANES, DM_ROUTE * DM_LANES // S + 1)
    log(f"phase 11: YCSB-A, {issued} requests over {N_KEYS} keys, {S} "
        f"shards x {DM_LANES} lanes (q = {q}), {NG} groups of {BATCH} "
        f"rounds, route_factor {DM_ROUTE}")
    out = dict(requests=issued, groups=NG, shards=S, lanes=DM_LANES, q=q)
    runs = {}
    for backend in ("fused", "reference"):
        cl = Cluster.make(dataclasses.replace(cfg, backend=backend), S,
                          DM_LANES, SEED, device=dev)
        ops.reset_launches()
        n_graphs = len(core_cache._GRAPHS)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cl, hits = cl.execute(k3, w3, route_factor=DM_ROUTE)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = cache_launches()
        captured = len(core_cache._GRAPHS) - n_graphs
        s, per = cl.stats, cl.dm.stats
        n_cached = cl.dm.state.n_cached.tolist()
        out[backend] = dict(
            wall_s=wall, requests_per_s=issued / wall,
            us_per_step=wall * 1e6 / NG, hit_ratio=hit_ratio(s),
            route_drops=int(s.route_drops), evictions=int(s.evictions),
            shard_evictions=per.evictions.tolist(), n_cached=n_cached,
            launches=launches, graphs_captured=captured)
        log(f"[{card}] phase 11 {backend}: {issued} requests in {wall:.2f} s "
            f"= {issued / wall:.0f} requests/s, {wall * 1e6 / NG:.0f} "
            f"us/step, hit ratio {hit_ratio(s):.4f}, route_drops "
            f"{int(s.route_drops)}, evictions {per.evictions.tolist()}, "
            f"n_cached {n_cached}, launches {launches}")
        runs[backend] = (hits, dm_parts(cl))
        if backend == "fused":
            fused = cl
        if int(s.gets + s.sets + s.route_drops) != issued:
            raise AssertionError(f"phase 11 {backend}: gets + sets + "
                                 f"route_drops != {issued} issued")
        if not bool((per.evictions > 0).all()):
            raise AssertionError(f"phase 11 {backend}: a shard never "
                                 f"evicted: {per.evictions.tolist()}")
        if (max(n_cached) - min(n_cached)) > DM_BALANCE * np.mean(n_cached):
            raise AssertionError(f"phase 11 {backend}: shards unbalanced: "
                                 f"{n_cached}")
        want = S * (NG + captured) if backend == "fused" else 0
        if any(n != want for n in launches.values()):
            raise AssertionError(f"phase 11 {backend}: launches {launches}, "
                                 f"not {want} ({S} a DM step)")
        if backend == "fused":
            for k in CACHE_KERNELS:
                results[k]["launches_dm"] = launches[k]
    (ha, pa), (hb, pb) = runs["fused"], runs["reference"]
    if not torch.equal(ha, hb):
        raise AssertionError("phase 11: fused and reference hits differ")
    if keep is not None:
        keep.update(hits=ha, k3=k3, w3=w3, dm=cpu_copy(fused.dm))
    same_parts("phase 11", pa, pb, 4, weight_ulp=16)

    # The sanitize-armed re-run of the first groups: it raises nothing
    # and reaches the unarmed run's state bit for bit.
    armed = {}
    for sanitize in (False, True):
        cl = Cluster.make(dataclasses.replace(cfg, sanitize=sanitize), S,
                          DM_LANES, SEED, device=dev)
        armed[sanitize] = cl.execute(k3[:DM_SAN_GROUPS], w3[:DM_SAN_GROUPS],
                                     route_factor=DM_ROUTE)
    if not torch.equal(armed[False][1], armed[True][1]):
        raise AssertionError("phase 11: the sanitized run's hits differ")
    same_parts("phase 11 sanitized", dm_parts(armed[False][0]),
               dm_parts(armed[True][0]), 0, weight_ulp=0)
    cl = Cluster.make(cfg, S, DM_LANES, SEED, device=dev)
    out["step_ops"] = dm_step_ops(dev, cl, k3[0], w3[0])
    if profile:
        profile_dm(dev, card, cfg, k3, w3, profile, out_dir)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 11: fused == reference (integers bit-equal, weights <= 16 "
        f"ulp); sanitize-armed first {DM_SAN_GROUPS} groups raise nothing "
        f"and equal the unarmed run; one eager fused DM step "
        f"{out['step_ops']['operators']} operators "
        f"({out['step_ops']['device_ops']} neither an allocation nor a "
        f"view); phase wall {out['wall_s']:.1f} s")
    return out, fused, keys


def run_failover(dev, card: str, results: dict,
                 keep: dict | None = None) -> dict:
    """Phase 12: ``benchmarks/elasticity.py``'s failover leg on phase 11's
    cluster shape, a replicated arm against a control, through
    ``run_scenario`` as the benchmark runs it: windows of 16 rounds, a
    ``HealthMonitor`` that marks the failed shard after two missed beats
    (the window-end observations of the failure's window and the next),
    and the replicas re-elected from the load EMA at every window.
    ``keep`` receives the trace and the replicated arm's windows and
    events (phase 18's)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.analysis.sanitize import SanitizerError
    from repro_torch.core import CacheConfig
    from repro_torch.core import cache as core_cache
    from repro_torch.elastic import HealthMonitor, run_scenario
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import failover_trace

    t_phase = time.perf_counter()
    S, W = DM_SHARDS, FAIL_WINDOW
    T = FAIL_GROUPS * W
    trace = failover_trace(T, DM_LANES, S, N_BUCKETS, hot_shard=FAIL_SHARD,
                           hot_fraction=0.7, n_hot=48, n_keys=N_KEYS, seed=7)
    issued = int((trace != 0).sum())
    t_fail, t_rec = FAIL_AT * W, RECOVER_AT * W
    timeline = [(t_fail, ("fail_shard", FAIL_SHARD)),
                (t_rec, ("recover_shard", FAIL_SHARD))]
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY)
    log(f"phase 12: failover_trace, {issued} requests ({FAIL_GROUPS} "
        f"windows of {W} rounds) through run_scenario, shard {FAIL_SHARD} "
        f"fails at window {FAIL_AT} and recovers at {RECOVER_AT}; a "
        f"HealthMonitor detects it")
    out = dict(requests=issued)
    n_graphs = len(core_cache._GRAPHS)
    for k in CACHE_KERNELS:
        results[k]["launches_failover"] = 0
    for name, n_hot in (("replicated", FAIL_HOT), ("control", 0)):
        ops.reset_launches()
        graphs = len(core_cache._GRAPHS)
        t0 = time.perf_counter()
        res = run_scenario(cfg, trace.ravel(), timeline, n_shards=S,
                           lanes_per_shard=DM_LANES, horizon=T, window=W,
                           health=HealthMonitor(S), replicate_hot=n_hot,
                           seed=7, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = cache_launches()
        want = S * (T + len(core_cache._GRAPHS) - graphs)
        if any(n != want for n in launches.values()):
            raise AssertionError(f"phase 12 {name}: launches {launches}, "
                                 f"not {want} ({S} a DM step)")
        for k in CACHE_KERNELS:
            results[k]["launches_failover"] += launches[k]
        # benchmarks/elasticity.py's row, from the window dicts.
        ws = res.windows
        pre = float(np.mean([w["hit_rate"] for w in ws
                             if w["t1"] <= t_fail and w["t0"] >= W]))
        outage = [w for w in ws if w["t0"] >= t_fail and w["t1"] <= t_rec]
        detect = next((w["t1"] for w in ws if not w["routed"][FAIL_SHARD]),
                      t_rec)
        rerouted = [w for w in outage if w["t0"] >= detect]
        after = [w for w in ws if w["t0"] >= t_rec]
        marks = [e["t"] for e in res.events if e["event"] == "mark_failed"]
        rewarm = next(e["report"] for e in res.events
                      if e["event"] == "recover_shard")
        out[name] = dict(
            wall_s=wall, pre_fail_hit_rate=pre,
            dip_depth_pp=100 * (pre - min(w["hit_rate"] for w in outage)),
            hit_rate=(float(np.mean([w["hit_rate"] for w in rerouted]))
                      if rerouted else 0.0),
            detect_windows=(detect - t_fail) // W, mark_failed_at=marks,
            recover_windows=next((i for i, w in enumerate(after)
                                  if w["hit_rate"] >= 0.9 * pre), len(after)),
            route_drops=sum(w["route_drops"] for w in ws),
            replica_writes=sum(w["replica_writes"] for w in ws),
            n_replicated=max(w["n_replicated"] for w in ws),
            enforced_evictions=sum(w["enforced_evictions"] for w in ws),
            rewarm=rewarm, launches=launches,
            windows=[round(w["hit_rate"], 6) for w in ws])
        log(f"[{card}] phase 12 {name}: {FAIL_GROUPS} windows in {wall:.2f} "
            f"s; pre-failure hit ratio {pre:.4f}, dip "
            f"{out[name]['dip_depth_pp']:.2f} pp, marked failed at round "
            f"{marks} (window {marks[0] // W if marks else None}), "
            f"rerouted-window hit ratio {out[name]['hit_rate']:.4f}, "
            f"route_drops {out[name]['route_drops']}, rewarm "
            f"{tuple(rewarm.values())}")
        s = res.cluster.stats
        if int(s.gets + s.sets + s.route_drops) != issued:
            raise AssertionError(f"phase 12 {name}: gets + sets + "
                                 f"route_drops != {issued} issued")
        if marks != [(FAIL_AT + 2) * W]:
            raise AssertionError(f"phase 12 {name}: the monitor marked the "
                                 f"shard failed at rounds {marks}, not at "
                                 f"window {FAIL_AT + 2} (two missed beats)")
        if any(w["routed"][FAIL_SHARD] != (w["t1"] <= (FAIL_AT + 2) * W
                                           or w["t0"] >= t_rec) for w in ws):
            raise AssertionError(f"phase 12 {name}: routing to shard "
                                 f"{FAIL_SHARD} did not stop from window "
                                 f"{FAIL_AT + 2} to the recovery")
        if rewarm["drained_objects"] <= 0:
            raise AssertionError(f"phase 12 {name}: the rewarm moved nothing")
        if keep is not None and name == "replicated":
            keep.update(trace=trace, windows=res.windows, events=res.events)
        cl = res.cluster
    if len(core_cache._GRAPHS) - n_graphs > 1:
        raise AssertionError("phase 12: a membership change re-captured the "
                             "DM step's graph")
    rep, ctl = out["replicated"], out["control"]
    # benchmarks/elasticity.py's three assertions.
    if not rep["dip_depth_pp"] < ctl["dip_depth_pp"] - 2.0:
        raise AssertionError(f"phase 12: replication did not flatten the "
                             f"dip: {rep['dip_depth_pp']:.2f} vs "
                             f"{ctl['dip_depth_pp']:.2f} pp")
    if not rep["route_drops"] < ctl["route_drops"]:
        raise AssertionError("phase 12: replication did not reduce bounced "
                             "requests")
    if not rep["hit_rate"] >= ctl["hit_rate"] - 0.02:
        raise AssertionError(f"phase 12: replicated recovery-window hit "
                             f"ratio {rep['hit_rate']:.4f} regressed from "
                             f"{ctl['hit_rate']:.4f}")
    kt = torch.as_tensor(trace.astype(np.int64), device=dev)

    # A duplicated live key in one bucket of shard 0, on a copy: the
    # sanitize-armed run raises SAN003 when its segment ends.
    ls, A = cl.local.n_slots, ASSOC
    live = ((cl.dm.state.size[:ls] != 0) & (cl.dm.state.size[:ls] != 255)
            ).reshape(-1, A)
    b = int(torch.nonzero(live.sum(dim=1) >= 2)[0, 0])
    i, j = (b * A + torch.nonzero(live[b])[:2, 0]).tolist()
    key = cl.dm.state.key.clone()
    key[j] = key[i]
    bad = cl._replace(local=dataclasses.replace(cl.local, sanitize=True),
                      dm=cl.dm._replace(state=cl.dm.state._replace(key=key)))
    try:
        bad.execute(kt[:W], route_factor=DM_ROUTE)
    except SanitizerError as e:
        if not str(e).startswith("SAN003"):
            raise AssertionError(f"phase 12: the corrupted copy raised {e}")
        out["sanitizer"] = str(e)
    else:
        raise AssertionError("phase 12: a duplicated live key went unseen")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 12: the replicated arm dips {rep['dip_depth_pp']:.2f} pp "
        f"against {ctl['dip_depth_pp']:.2f} (a fixed-delay detection at "
        f"window 68 dipped 15.74 against 33.72), drops "
        f"{rep['route_drops']} against {ctl['route_drops']}, rerouted hit "
        f"ratio {rep['hit_rate']:.4f} against {ctl['hit_rate']:.4f}; "
        f"detected at window {FAIL_AT + 2}; no graph re-captured across "
        f"the membership changes; the corrupted copy raised "
        f"\"{out['sanitizer']}\"; phase wall {out['wall_s']:.1f} s")
    return out


def cpu_copy(dm):
    """A DMCache's leaves copied to the host."""
    return type(dm)(*[type(part)(*[x.cpu().clone() for x in part])
                      for part in dm])


def recount(tag: str, dm, ls: int) -> None:
    """n_cached, bytes_cached and tenant_bytes equal a recount from the
    columns."""
    import torch
    st = dm.state
    S = st.n_cached.shape[0]
    live = ((st.size != 0) & (st.size != 255)).view(S, ls)
    sz = torch.where(live, st.size.view(S, ls), 0)
    tb = torch.zeros_like(st.tenant_bytes).scatter_add_(
        1, st.tenant.view(S, ls), sz)
    if not (torch.equal(live.sum(dim=1), st.n_cached)
            and torch.equal(sz.sum(dim=1), st.bytes_cached)
            and torch.equal(tb, st.tenant_bytes)):
        raise AssertionError(f"phase 13 {tag}: n_cached, bytes_cached or "
                             f"tenant_bytes differ from a recount")


def dominant_priorities(cl):
    """[S, local_slots] priorities of every slot under its shard's
    dominant expert (the drain's order), and the live mask."""
    import torch
    from repro_torch.core import priority as prio
    from repro_torch.core.types import MDView
    st, S, ls = cl.dm.state, cl.n_shards, cl.local.n_slots
    f = lambda c: c.view(S, ls).to(torch.float32)
    md = MDView(size=f(st.size), insert_ts=f(st.insert_ts),
                last_ts=f(st.last_ts), freq=f(st.freq),
                ext=st.ext.view(S, ls, -1),
                clock=st.clock[:, None].to(torch.float32),
                gds_L=st.gds_L[:, None],
                cost=torch.ones((S, ls), dtype=torch.float32,
                                device=st.key.device))
    pr = prio.priorities(md, cl.local.experts)
    e = torch.argmax(st.weights, dim=1)
    pe = torch.gather(pr, 2, e[:, None, None].expand(S, ls, 1))[..., 0]
    return pe, ((st.size != 0) & (st.size != 255)).view(S, ls)


def ycsb_a_continuation(keys11, n: int):
    """More of phase 11's YCSB-A: the same scrambled zipf 0.99 over the
    same 10M keys (phase 11's permutation, checked against its keys),
    fresh draws from seed SEED + 1, 50% SETs."""
    import numpy as np
    from repro_torch.workloads.gen import _zipf_probs
    p = _zipf_probs(N_KEYS, 0.99)
    rng = np.random.default_rng(SEED)
    ranks = rng.choice(N_KEYS, size=DM_REQUESTS, p=p)
    perm = rng.permutation(N_KEYS)
    if not np.array_equal((perm[ranks] + 1).astype(np.uint32), keys11):
        raise AssertionError("phase 13: not phase 11's key permutation")
    more = np.random.default_rng(SEED + 1)
    keys = (perm[more.choice(N_KEYS, size=n, p=p)] + 1).astype(np.uint32)
    return keys, more.random(n) < 0.5


def run_elastic(dev, card: str, results: dict, cl, keys11,
                profile: int = 0, out_dir: Path | None = None,
                keep: dict | None = None) -> dict:
    """Phase 13: the elastic pool on the card.  (a) At full size, on phase
    11's final fused cluster: lanes 8 -> 16 and capacity x2 (a scalar
    write), 64 groups at 16 lanes a shard, the lane flush back to 8 and
    the shrink drain to a quarter of the grown capacity, the budget
    sweep, 64 groups at 8 lanes; the lane shrink and the first drain
    steps against the port's CPU leg on a host copy.  (b) At
    ``benchmarks/elasticity.py``'s own size through ``run_scenario``,
    without and with a ``WidthController``.  ``keep`` receives (a)'s
    inputs, sizes, reports and final DMCache (phase 18's)."""
    import numpy as np
    import torch
    from repro_torch.core import CacheConfig
    from repro_torch.core import cache as core_cache
    from repro_torch.elastic import run_scenario
    from repro_torch.elastic import resize as rz
    from repro_torch.elastic.controller import WidthController
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import interleave, ycsb

    t_phase = time.perf_counter()
    S, ls, G = cl.n_shards, cl.local.n_slots, BATCH
    wide, narrow = ELASTIC_LANES
    cap0 = int(cl.dm.state.capacity_blocks.sum())
    grown, shrunk = 2 * cap0, cap0 // 2
    n1, n2 = (ELASTIC_GROUPS * G * S * wide, ELASTIC_GROUPS * G * S * narrow)
    k_more, w_more = ycsb_a_continuation(keys11, n1 + n2)
    k3a, w3a = dm_inputs(*interleave(k_more[:n1], S * wide, w_more[:n1]),
                         ELASTIC_GROUPS, G, dev)
    k3b, w3b = dm_inputs(*interleave(k_more[n1:], S * narrow, w_more[n1:]),
                         ELASTIC_GROUPS, G, dev)
    live0 = int(cl.dm.state.n_cached.sum())
    log(f"phase 13 (a): phase 11's cluster ({S} shards x "
        f"{cl.lanes_per_shard} lanes, {S * ls} slots, capacity {cap0}, "
        f"{live0} live objects): lanes {narrow} -> {wide}, capacity "
        f"{cap0} -> {grown}, {ELASTIC_GROUPS} groups of [{G}, {S * wide}], "
        f"lanes -> {narrow}, drain to {shrunk} ({ELASTIC_BATCH} a shard a "
        f"step), {ELASTIC_GROUPS} groups of [{G}, {S * narrow}]")
    out: dict = dict(live_before=live0)
    launched = {k: 0 for k in CACHE_KERNELS}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(dev)
        return r, time.perf_counter() - t0

    def segment(tag, c, k3, w3, captures):
        ops.reset_launches()
        g0 = len(core_cache._GRAPHS)
        (c, _), wall = timed(lambda: c.execute(k3, w3, route_factor=DM_ROUTE))
        got = cache_launches()
        new = len(core_cache._GRAPHS) - g0
        want = S * (k3.shape[0] + captures)
        if new != captures or any(n != want for n in got.values()):
            raise AssertionError(f"phase 13 {tag}: launches {got}, {new} "
                                 f"graphs captured; want {want} ({S} a DM "
                                 f"step) and {captures} capture")
        for k in CACHE_KERNELS:
            launched[k] += got[k]
        issued = int((k3 != 0).sum())
        out[tag] = dict(requests=issued, wall_s=wall,
                        requests_per_s=issued / wall, launches=got)
        log(f"[{card}] phase 13 {tag}: {issued} requests in {wall:.2f} s = "
            f"{issued / wall:.0f} requests/s, launches {got} ({captures} "
            f"capture)")
        return c

    # 1. The grow: lanes, then the capacity write alone.
    (cl, rep), wall = timed(lambda: cl.with_lanes(wide))
    out["lanes_grow"] = dict(wall_s=wall, report=tuple(rep))
    before = cl.dm
    (cl, rep), wall = timed(lambda: cl.drain_to(grown))
    out["grow"] = dict(wall_s=wall, report=tuple(rep))
    if tuple(rep) != (0, 0, 0, 0):
        raise AssertionError(f"phase 13: the grow drained or moved: {rep}")
    for part, a, b in zip(("state", "clients", "stats"), before, cl.dm):
        for f, x, y in zip(a._fields, a, b):
            if (x is not y) != (part == "state" and f == "capacity_blocks"):
                raise AssertionError(f"phase 13: the grow wrote {part}.{f}")
    if cl.dm.state.capacity_blocks.tolist() != [grown // S] * S:
        raise AssertionError("phase 13: the grown capacity is not written")

    # 2. 64 groups at the new width: one new graph.
    cl = segment("wide", cl, k3a, w3a, 1)

    # 3. The flush back to 8 lanes and the shrink drain; the lane shrink
    # and the first drain steps also on a host copy, the CPU leg.
    host = cl._replace(device=torch.device("cpu"), dm=cpu_copy(cl.dm))
    (cl, rep), wall = timed(lambda: cl.with_lanes(narrow))
    out["lanes_shrink"] = dict(wall_s=wall, report=tuple(rep))
    host, hrep = host.with_lanes(narrow)
    if tuple(rep) != tuple(hrep) or rep.migration_bytes:
        raise AssertionError(f"phase 13: lane shrink reports {rep}, {hrep}")
    same_parts("phase 13: the lane shrink against the CPU leg", cl.dm,
               host.dm, 0, weight_ulp=0)
    card8 = rz._set_capacity_impl(cl.dm, shrunk, S)
    host8 = rz._set_capacity_impl(host.dm, shrunk, S)
    for _ in range(ELASTIC_CPU_STEPS):
        st, sa, _, _ = rz._drain_step(cl.local, ELASTIC_BATCH, card8.state,
                                      card8.stats)
        card8 = card8._replace(state=st, stats=sa)
        st, sa, _, _ = rz._drain_step(cl.local, ELASTIC_BATCH, host8.state,
                                      host8.stats)
        host8 = host8._replace(state=st, stats=sa)
    same_parts(f"phase 13: the first {ELASTIC_CPU_STEPS} drain steps "
               f"against the CPU leg", card8, host8, 0, weight_ulp=0)
    del host, host8, card8
    pe, live_b = dominant_priorities(cl)
    ev_b, hist_b = cl.dm.stats.evictions.clone(), cl.dm.state.hist_ctr.clone()
    bytes_b = cl.dm.state.bytes_cached.clone()
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace
        st0 = rz._set_capacity_impl(cl.dm, shrunk, S)
        rz._drain_step(cl.local, ELASTIC_BATCH, st0.state, st0.stats)
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            _, wall1 = timed(lambda: rz._drain_step(
                cl.local, ELASTIC_BATCH, st0.state, st0.stats))
        cats = report_profile(prof, card, "drain_step", 1, wall1, out_dir)
        out["drain_step_profile"] = dict(
            kernels=cats.pop("kernels"), device_us=sum(cats.values()),
            wall_us=wall1 * 1e6)
        del st0
    (cl, rep), wall = timed(lambda: cl.drain_to(
        shrunk, batch_per_shard=ELASTIC_BATCH))
    out["drain"] = dict(wall_s=wall, report=tuple(rep),
                        objects_per_s=rep.drained_objects / wall)
    log(f"[{card}] phase 13 drain: {rep.drain_steps} steps (limit 256), "
        f"{rep.drained_objects} objects, {rep.drained_bytes} bytes in "
        f"{wall:.3f} s = {rep.drained_objects / wall:.0f} objects/s; lane "
        f"resizes {out['lanes_grow']['wall_s']:.3f} s (grow) and "
        f"{out['lanes_shrink']['wall_s']:.3f} s (flush); one drain step "
        + (f"{out['drain_step_profile']['device_us']:.0f} us of device time "
           f"in {out['drain_step_profile']['kernels']} kernels"
           if profile else "not traced (--profile)"))
    st = cl.dm.state
    if rep.migration_bytes or rep.drain_steps < 1:
        raise AssertionError(f"phase 13: the shrink reported {rep}")
    if not bool((st.bytes_cached <= st.capacity_blocks).all()):
        raise AssertionError(f"phase 13: bytes_cached "
                             f"{st.bytes_cached.tolist()} over the capacity")
    recount("after the drain", cl.dm, ls)
    live_a = ((st.size != 0) & (st.size != 255)).view(S, ls)
    drained = live_b & ~live_a
    per = drained.sum(dim=1)
    if not (torch.equal(cl.dm.stats.evictions - ev_b, per)
            and torch.equal((st.hist_ctr - hist_b) & 0xFFFFFFFF, per)
            and int(per.sum()) == rep.drained_objects
            and int((bytes_b - st.bytes_cached).sum()) * 64
            == rep.drained_bytes
            and not bool((live_a & ~live_b).any())):
        raise AssertionError("phase 13: evictions, hist_ctr or the bytes "
                             "did not move by the drained objects")
    hi = torch.where(drained, pe, -float("inf")).max(dim=1).values
    lo = torch.where(live_a, pe, float("inf")).min(dim=1).values
    if not bool((hi <= lo).all()):
        raise AssertionError("phase 13: a drained object outranked a "
                             "surviving one under the dominant expert")

    # 4. The budget sweep drains nothing; 5. 64 groups at 8 lanes on
    # phase 11's graph.
    dm, swept = rz.enforce_budget(cl.local, cl.dm)
    if swept:
        raise AssertionError(f"phase 13: enforce_budget drained {swept}")
    cl = segment("narrow", cl._replace(dm=dm), k3b, w3b, 0)
    st = cl.dm.state
    if not bool((st.bytes_cached <= st.capacity_blocks + G * S * narrow)
                .all()):
        raise AssertionError(f"phase 13: bytes_cached "
                             f"{st.bytes_cached.tolist()} more than a "
                             f"group over the capacity")
    recount("after the last segment", cl.dm, ls)
    out["bytes_cached"] = st.bytes_cached.tolist()
    if keep is not None:
        keep.update(
            inputs=(k3a, w3a, k3b, w3b), sizes=(wide, narrow, grown, shrunk),
            reports=[out[k]["report"] for k in ("lanes_grow", "grow",
                                                "lanes_shrink", "drain")],
            dm=cpu_copy(cl.dm))

    # (b) The benchmark's own size through run_scenario.
    keys, _ = ycsb("C", SCENARIO_REQUESTS, n_keys=SCENARIO_KEYS, seed=0)
    cfg = CacheConfig(n_buckets=4096, assoc=8, capacity=8192,
                      experts=("lru", "lfu"))
    lanes0 = 32
    T = SCENARIO_REQUESTS // lanes0
    t1, t2 = T // 3, 2 * T // 3
    timeline = [(t1, ("set_lanes", 64)), (t1, ("set_capacity", 16384)),
                (t2, ("set_lanes", 32)), (t2, ("set_capacity", 4096))]
    runs = {}
    for tag, wc in (("fixed", None), ("width_controller", WidthController())):
        ops.reset_launches()
        g0 = len(core_cache._GRAPHS)
        res, wall = timed(lambda: run_scenario(
            cfg, keys, timeline, n_shards=1, lanes_per_shard=lanes0,
            horizon=T, window=max(T // 40, 1), width_controller=wc,
            device=dev))
        got = cache_launches()
        new = len(core_cache._GRAPHS) - g0
        if any(n != T + new for n in got.values()):
            raise AssertionError(f"phase 13 (b) {tag}: launches {got}, not "
                                 f"{T + new}")
        for k in CACHE_KERNELS:
            launched[k] += got[k]
        shrink = [e for e in res.events if e["event"] == "set_capacity"
                  and e["t"] >= t2][0]["report"]
        mig = sum(e["report"]["migration_bytes"] for e in res.events)
        after = int(res.dm.state.n_cached.sum())
        runs[tag] = res
        out["scenario_" + tag] = dict(
            wall_s=wall, requests_per_s=SCENARIO_REQUESTS / wall,
            tput_32c_mops=float(res.phase(0, t1, "tput_mops").mean()),
            tput_64c_mops=float(res.phase(t1, t2, "tput_mops").mean()),
            migration_bytes=mig, shrink_drain_steps=shrink["drain_steps"],
            n_cached_after_shrink=after, graphs_captured=new,
            widths=list(wc.log) if wc else [lanes0], launches=got)
        log(f"[{card}] phase 13 (b) {tag}: {SCENARIO_REQUESTS} requests in "
            f"{wall:.2f} s; model throughput "
            f"{out['scenario_' + tag]['tput_32c_mops']:.2f} Mops at 32 "
            f"lanes, {out['scenario_' + tag]['tput_64c_mops']:.2f} at 64; "
            f"migration {mig} bytes; shrink drain "
            f"{shrink['drain_steps']} steps, {shrink['drained_objects']} "
            f"objects; n_cached after {after}"
            + (f"; widths {wc.log}" if wc else ""))
        # benchmarks/elasticity.py's assertions.
        if mig != 0 or shrink["drain_steps"] < 1 or after > 4096 + 64:
            raise AssertionError(f"phase 13 (b) {tag}: migration {mig}, "
                                 f"drain steps {shrink['drain_steps']}, "
                                 f"n_cached {after}")
    a, b = runs["fixed"].windows, runs["width_controller"].windows
    if a != b or runs["fixed"].events != runs["width_controller"].events:
        raise AssertionError("phase 13 (b): the width controller's chunking "
                             "changed a window")
    for k in CACHE_KERNELS:
        results[k]["launches_elastic"] = launched[k]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13: the grow wrote the capacity alone; the drain left every "
        f"shard within its capacity, evicted no object ranked above a "
        f"survivor, and equals the CPU leg for its first "
        f"{ELASTIC_CPU_STEPS} steps (the lane flush in full); "
        f"(b) {len(a)} windows equal with and without the width "
        f"controller; phase wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the pool across ranks.
# ---------------------------------------------------------------------------

RANKS = (2, 4)            # (b)'s process counts on the one card
RANKS_LEGS = {2: ("dm",), 4: ("dm", "failover", "elastic")}
RANKS_TIMEOUT = 600       # seconds for every rank of one arm to exit


def same_block(tag: str, want, got, pool) -> None:
    """A rank's DMCache bit-equal to its block of the one-card one (a
    host copy), leaf by leaf, floats included."""
    import torch
    for part, a, b in zip(("state", "clients", "stats"), pool.block(want),
                          got):
        for f, x, y in zip(a._fields, a, b):
            if x.shape != y.shape or not torch.equal(x, y.cpu()):
                raise AssertionError(f"{tag}: {part}.{f} differs from its "
                                     f"block of the one-card run")


@contextlib.contextmanager
def collective_time(acc: dict):
    """Host seconds and calls of each ``Pool`` collective while entered
    (gloo's calls block the host until done; NCCL's return once
    enqueued)."""
    from repro_torch.dm import ranks
    names = ("exchange", "gather_ranks", "any_", "sum_", "broadcast")
    saved = {n: getattr(ranks.Pool, n) for n in names}

    def timed(name, fn):
        def call(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kw)
            finally:
                s, n = acc.get(name, (0.0, 0))
                acc[name] = (s + time.perf_counter() - t0, n + 1)
        return call

    for n, fn in saved.items():
        setattr(ranks.Pool, n, timed(n, fn))
    try:
        yield acc
    finally:
        for n, fn in saved.items():
            setattr(ranks.Pool, n, fn)


def ranks_dm(dev, tag: str, group, want: dict):
    """Phase 11's fused run through ``Cluster.make(..., group=)``: the
    rank's shards and the hits against phase 11's.  Returns (the rank's
    final cluster, its numbers)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import CacheConfig
    from repro_torch.core import cache as core_cache
    from repro_torch.dm import Cluster
    from repro_torch.kernels import ops
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY)
    k3, w3 = want["k3"].to(dev), want["w3"].to(dev)
    NG = k3.shape[0]
    cl = Cluster.make(cfg, DM_SHARDS, DM_LANES, SEED, device=dev,
                      group=group)
    ops.reset_launches()
    graphs = len(core_cache._GRAPHS)
    dist.barrier(group)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with collective_time({}) as coll:
        cl, hits = cl.execute(k3, w3, route_factor=DM_ROUTE)
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = cache_launches()
    captured = len(core_cache._GRAPHS) - graphs
    if not torch.equal(hits.cpu(), want["hits"]):
        raise AssertionError(f"phase 18 {tag}: hits differ from phase 11's")
    same_block(f"phase 18 {tag}", want["dm"], cl.dm, cl.pool)
    n_local = cl.pool.n_local
    per = n_local * (NG + captured)
    if any(n != per for n in launches.values()):
        raise AssertionError(f"phase 18 {tag}: launches {launches}, not "
                             f"{per} ({n_local} a DM step)")
    issued = int((k3 != 0).sum())
    return cl, dict(wall_s=wall, requests_per_s=issued / wall,
                    us_per_step=wall * 1e6 / NG, launches=launches,
                    graphs_captured=captured, shards=n_local,
                    collectives_s={n: t for n, (t, _) in coll.items()},
                    collective_calls={n: c for n, (_, c) in coll.items()})


def ranks_failover(dev, group, want: dict) -> dict:
    """Phase 12's replicated arm through ``run_scenario(group=)``: every
    window and event equal to the one-card arm's."""
    import torch
    from repro_torch.core import CacheConfig
    from repro_torch.elastic import HealthMonitor, run_scenario
    S, W = DM_SHARDS, FAIL_WINDOW
    T = FAIL_GROUPS * W
    cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC, capacity=CAPACITY)
    timeline = [(FAIL_AT * W, ("fail_shard", FAIL_SHARD)),
                (RECOVER_AT * W, ("recover_shard", FAIL_SHARD))]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = run_scenario(cfg, want["trace"].ravel(), timeline, n_shards=S,
                       lanes_per_shard=DM_LANES, horizon=T, window=W,
                       health=HealthMonitor(S), replicate_hot=FAIL_HOT,
                       seed=7, device=dev, group=group)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(want["windows"], res.windows)):
        if a != b:
            raise AssertionError(f"phase 18 failover: window {i} differs "
                                 f"from phase 12's replicated arm")
    if (len(res.windows) != len(want["windows"])
            or res.events != want["events"]):
        raise AssertionError("phase 18 failover: the windows or events "
                             "differ from phase 12's replicated arm")
    return dict(wall_s=wall, windows=len(res.windows))


def ranks_elastic(dev, cl, want: dict) -> dict:
    """Phase 13 (a)'s sequence on the rank's phase-11 cluster: the lane
    grow, the capacity grow, 64 groups at 16 lanes, the lane flush, the
    shrink drain, the budget sweep and 64 groups at 8 lanes; the reports
    and the final shards equal phase 13 (a)'s."""
    import torch
    from repro_torch.elastic import resize as rz
    k3a, w3a, k3b, w3b = (x.to(dev) for x in want["inputs"])
    wide, narrow, grown, shrunk = want["sizes"]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    reports = []
    cl, rep = cl.with_lanes(wide)
    reports.append(tuple(rep))
    cl, rep = cl.drain_to(grown)
    reports.append(tuple(rep))
    cl, _ = cl.execute(k3a, w3a, route_factor=DM_ROUTE)
    cl, rep = cl.with_lanes(narrow)
    reports.append(tuple(rep))
    cl, rep = cl.drain_to(shrunk, batch_per_shard=ELASTIC_BATCH)
    reports.append(tuple(rep))
    dm, swept = rz.enforce_budget(cl.local, cl.dm, pool=cl.pool)
    cl, _ = cl._replace(dm=dm).execute(k3b, w3b, route_factor=DM_ROUTE)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if reports != [tuple(r) for r in want["reports"]] or swept:
        raise AssertionError(f"phase 18 elastic: reports {reports} (swept "
                             f"{swept}), phase 13 (a): {want['reports']}")
    same_block("phase 18 elastic", want["dm"], cl.dm, cl.pool)
    return dict(wall_s=wall, reports=reports)


def ranks_worker(rank: int, world: int, work: str, backend: str,
                 legs: tuple) -> None:
    """One rank of (b) or (c): phase 11's run, then ``legs``' others;
    its numbers to ``work/r{world}_{backend}_{rank}.json``."""
    import os
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    work = Path(work)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(
        str(work / f"store_{world}_{backend}"), world), rank=rank,
        world_size=world)
    try:
        group = dist.group.WORLD
        want = torch.load(work / "phase11.pt", weights_only=False)
        cl, out = ranks_dm(dev, f"R = {world} {backend} rank {rank}",
                           group, want)
        if "failover" in legs:
            out["failover"] = ranks_failover(
                dev, group, torch.load(work / "phase12.pt",
                                       weights_only=False))
        if "elastic" in legs:
            out["elastic"] = ranks_elastic(
                dev, cl, torch.load(work / "phase13.pt", weights_only=False))
        (work / f"r{world}_{backend}_{rank}.json").write_text(
            json.dumps(out, default=float))
    finally:
        dist.destroy_process_group()


def spawn_ranks(work: Path, world: int, backend: str, legs: tuple) -> list:
    """``world`` ranks of :func:`ranks_worker`, joined; any rank's
    failure raises here.  Returns each rank's numbers."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(ranks_worker,
                             args=(world, str(work), backend, legs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + RANKS_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 18 R = {world} {backend}: the "
                                     f"ranks did not exit in "
                                     f"{RANKS_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    return [json.loads((work / f"r{world}_{backend}_{r}.json").read_text())
            for r in range(world)]


def log_arm(card: str, tag: str, outs: list, issued: int, NG: int) -> dict:
    """An arm's requests/s and µs a DM step: the slowest rank's wall."""
    wall = max(o["wall_s"] for o in outs)
    coll = ", ".join(f"{n} {t:.2f} s ({outs[0]['collective_calls'][n]})"
                     for n, t in outs[0]["collectives_s"].items())
    log(f"[{card}] phase 18 {tag}: {issued} requests in {wall:.2f} s = "
        f"{issued / wall:.0f} requests/s, {wall * 1e6 / NG:.0f} us/step; "
        f"each rank's launches {outs[0]['launches']}; rank 0's host time "
        f"in the collectives (calls): {coll}")
    return dict(wall_s=wall, requests_per_s=issued / wall,
                us_per_step=wall * 1e6 / NG, ranks=outs)


def run_ranks(dev, card: str, results: dict, k11: dict, k12: dict,
              k13: dict) -> dict:
    """Phase 18: (a) one NCCL rank here, (b) R = 2 and 4 gloo processes
    on this card, (c) one NCCL rank a card where there are several, each
    held to phases 11, 12 and 13 (a) (``k11``, ``k12``, ``k13``: what
    they kept)."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import runtime
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    want11 = dict(hits=k11["hits"].cpu(), k3=k11["k3"].cpu(),
                  w3=k11["w3"].cpu(), dm=k11["dm"])
    NG = want11["k3"].shape[0]
    issued = int((want11["k3"] != 0).sum())
    log(f"phase 18: phase 11's cluster ({DM_SHARDS} shards x {DM_LANES} "
        f"lanes, {issued} requests, {NG} groups) through Cluster.make("
        f"group=): one NCCL rank here, then {RANKS} gloo processes on this "
        f"card, then one NCCL rank a card")
    out: dict = {}

    # (a) One NCCL rank in this process, every shard local.
    runtime.lib()
    torch.cuda.set_device(dev)
    M._group("nccl", 1, dist.HashStore)
    try:
        _, a = ranks_dm(dev, "(a) one NCCL rank", dist.group.WORLD,
                        want11)
    finally:
        M.teardown()
    for k in CACHE_KERNELS:
        results[k]["launches_ranks"] = a["launches"][k]
    out["one_rank_nccl"] = log_arm(card, "(a) one NCCL rank", [a], issued,
                                   NG)

    # (b) and (c) in processes: the kernels are built (above), the inputs
    # written where every rank reads them.
    work = ROOT / "build" / f"phase18_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        torch.save(want11, work / "phase11.pt")
        torch.save(dict(trace=k12["trace"], windows=k12["windows"],
                        events=k12["events"]), work / "phase12.pt")
        torch.save(dict(inputs=tuple(x.cpu() for x in k13["inputs"]),
                        sizes=k13["sizes"], reports=k13["reports"],
                        dm=k13["dm"]), work / "phase13.pt")
        for world in RANKS:
            outs = spawn_ranks(work, world, "gloo", RANKS_LEGS[world])
            out[f"gloo_{world}"] = log_arm(
                card, f"(b) {world} gloo ranks on one card", outs, issued, NG)
            for leg in ("failover", "elastic"):
                if leg in RANKS_LEGS[world]:
                    wall = max(o[leg]["wall_s"] for o in outs)
                    log(f"[{card}] phase 18 (b) {world} gloo ranks, "
                        f"{leg}: {wall:.2f} s, equal to phase "
                        f"{12 if leg == 'failover' else '13 (a)'}")
        n_cards = torch.cuda.device_count()
        world = max((r for r in (2, 4, 8) if r <= n_cards), default=0)
        if world:
            outs = spawn_ranks(work, world, "nccl", ("dm",))
            out[f"nccl_{world}"] = log_arm(
                card, f"(c) {world} NCCL ranks, one a card", outs, issued,
                NG)
        else:
            log(f"phase 18 (c): not run: {n_cards} card on this machine "
                f"(one NCCL rank a card needs two or more)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18: (a) and (b) bit-equal to phase 11's fused run on every "
        f"rank; R = 4 equals phase 12's replicated arm window by window and "
        f"phase 13 (a)'s leaves; phase wall {out['wall_s']:.1f} s")
    return out


# Operators that launch no device work: allocations and views.
NO_KERNEL = ("empty", "view", "reshape", "expand", "select", "slice",
             "unsqueeze", "squeeze", "permute", "alias", "as_strided", "lift",
             "detach")


def step_ops(dev, cfg, gp) -> tuple:
    """The operators of one eager grouped step (the plan's first group, on
    a fresh cache of ``cfg``): (every operator, in order; those whose
    result has a whole column's rows or more, as (operator, shape); the
    calls the step made to ``core.prng``'s ``fold_in`` and ``uniform``).
    The hand-written kernels are called through ctypes, not as operators,
    so they are not among them; allocations (``empty``) move no bytes and
    are left out of the second list."""
    from unittest import mock
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.core import make, prng
    from repro_torch.core.cache import access_group_

    n = cfg.n_slots
    called, whole, drawn = [], [], []

    def counted(name):
        fn = getattr(prng, name)

        def call(*a, **kw):
            drawn.append(name)
            return fn(*a, **kw)
        return mock.patch.object(prng, name, call)

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            called.append(str(func))
            if "empty" not in str(func):
                whole.extend((str(func), tuple(t.shape))
                             for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor) and t.dim()
                             and t.shape[0] >= n)
            return out

    c = make(cfg, LANES, SEED, device=dev)
    g = {k: torch.from_numpy(getattr(gp, k)[0].astype(
        bool if k == "is_write" else "int64")).to(dev)
        for k in ("keys", "is_write", "sizes", "tenants")
        if getattr(gp, k, None) is not None}
    step = lambda: access_group_(cfg, c.state, c.clients, c.stats,
                                 g["keys"], is_write=g["is_write"],
                                 obj_size=g["sizes"], tenant=g.get("tenants"))
    step()                                     # builds and counters first
    with counted("fold_in"), counted("uniform"), Watch():
        step()
    return called, whole, drawn


def check_step_traffic(dev, cfg, gp, strict: bool = True,
                       tag: str = "") -> dict:
    """Phase 3's step check: the fused step returns no whole column but the
    two of the ``bytes_cached`` reduction (``size == 255`` and the masked
    sizes), so it moves no column through a clone, copy, concatenation or
    fill, and it calls no ``core.prng`` function (the eviction kernel
    draws each request's offset and expert choice); the reference step's
    whole-column operators are listed.  Both steps' operators are
    counted: all of them, those that may launch device work (no
    allocation or view), and the bitwise ops and shifts among them.  Not
    ``strict`` (``--step-only``, which also runs an older checkout's
    step), the prng calls are counted, not refused."""
    import dataclasses
    out = {}
    for backend in ("fused", "reference"):
        called, whole, drawn = step_ops(
            dev, dataclasses.replace(cfg, backend=backend), gp)
        work = [o for o in called if not any(k in o for k in NO_KERNEL)]
        bitwise = [o for o in called if "bitwise" in o or "shift" in o]
        out[backend] = dict(operators=len(called), device_ops=len(work),
                            bitwise_ops=len(bitwise), prng_calls=len(drawn),
                            whole_column=whole)
        log(f"one eager {backend} step{tag}: {len(called)} operators, "
            f"{len(work)} of them neither an allocation nor a view, "
            f"{len(bitwise)} bitwise ops and shifts; {len(drawn)} calls to "
            f"core.prng; {len(whole)} return a whole column ({cfg.n_slots} "
            f"rows): "
            + (", ".join(f"{o} {list(sh)}" for o, sh in whole) or "none"))
    fused = [o for o, _ in out["fused"]["whole_column"]]
    if (len(fused) != 2 or not fused[0].startswith("aten.eq")
            or not fused[1].startswith("aten.where")):
        raise AssertionError(f"the fused step moves whole columns: "
                             f"{out['fused']['whole_column']}")
    if strict and out["fused"]["prng_calls"]:
        raise AssertionError("the fused step called core.prng "
                             f"{out['fused']['prng_calls']} times: its draw "
                             "belongs in the eviction kernel")
    log(f"the fused step{tag}: no whole-column clone, copy, concatenation "
        "or fill; only the bytes_cached reduction reads the size column "
        "whole" + ("; no core.prng call" if strict else ""))
    return out


# Kernel-name groups for the profile summary (first match wins).
PROFILE_GROUPS = (
    ("hand-written", ("access_probe_kernel", "ranked_eviction_kernel",
                      "hmu_init_kernel", "hmu_combine_faa_kernel",
                      "hmu_write_kernel", "drop_scatter_kernel",
                      "flash_bf16_kernel")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
    ("device copies", ("Memcpy DtoD", "memcpy", "direct_copy_kernel")),
    ("concatenation", ("CatArrayBatchedCopy",)),
    ("bitwise and shifts", ("Bitwise", "shift_kernel")),
    ("integer adds", ("CUDAFunctor_add", "CUDAFunctorOnSelf_add")),
    ("reductions and scans", ("reduce_kernel", "scan", "cumsum")),
    ("gather, scatter, index", ("scatter_gather", "index_elementwise",
                                "index_kernel", "gather")),
    ("fills", ("FillFunctor",)),
    ("sorts", ("radixSort", "RadixSort")),
)
# Phase 14's train step: the plain attention's f32 passes show as softmax,
# casts and other elementwise kernels.
TRAIN_PROFILE_GROUPS = (
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
    ("softmax", ("softmax", "SoftMax")),
    ("casts and copies", ("direct_copy_kernel", "Memcpy", "memcpy")),
    ("reductions", ("reduce_kernel",)),
    ("gather, scatter, index, sorts", ("scatter_gather", "index", "gather",
                                       "adixSort")),
    ("fills", ("FillFunctor",)),
    ("other elementwise", ("elementwise_kernel",)),
)


def profile_steps(dev, card: str, gp, trace, n_groups: int,
                  out_dir: Path | None, cfg=None, tag: str = "") -> None:
    """Trace the first n_groups steps of the grouped run under each
    backend with torch.profiler; print where the device time goes (per
    step, and the busy share of the wall) and, given ``out_dir``, write
    the whole kernel table there.  The window includes ``execute()``'s
    copy of the carry's small leaves into the step's graph and out again,
    once a segment (each call donates the table and the next runs on the
    handle it returns); a second window of twice the steps, less the
    first, gives the step alone.  ``cfg``: the cache's config (default:
    phase 3's), for phases 9 and 10 (``tag`` names them)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import CacheConfig, execute, make

    def first(k):
        return gp._replace(keys=gp.keys[:k], is_write=gp.is_write[:k],
                           sizes=gp.sizes[:k], src_t=gp.src_t[:k],
                           tenants=None if gp.tenants is None
                           else gp.tenants[:k])

    if cfg is None:
        cfg = CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC,
                          capacity=CAPACITY)
    for backend in ("fused", "reference"):
        c = make(dataclasses.replace(cfg, backend=backend), LANES, SEED,
                 device=dev)
        # build + allocator warm
        c = execute(c, trace, plan=first(n_groups)).cache
        cats = []
        for k in (n_groups, 2 * n_groups):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                r = execute(c, trace, plan=first(k))
            c = r.cache
            cats.append(report_profile(prof, card, backend + tag, k,
                                       r.wall_s,
                                       out_dir if k == n_groups else None))
        step = {kind: (t - cats[0].get(kind, 0.0)) / n_groups
                for kind, t in cats[1].items()}
        n_kernels = step.pop("kernels")
        log(f"    the step alone ({2 * n_groups} less {n_groups} steps), "
            f"device {sum(step.values()):.0f} us/step in {n_kernels:.0f} "
            f"kernels/step; by kind, us/step: "
            + ", ".join(f"{c} {t:.1f}" for c, t in
                        sorted(step.items(), key=lambda x: -x[1])))


def report_profile(prof, card: str, tag: str, n_steps: int, wall_s: float,
                   out_dir: Path | None, groups=PROFILE_GROUPS) -> dict:
    """Print where a traced window's device time goes (per step, and the
    busy share of the wall) and, given ``out_dir``, write the whole
    kernel table there.  Only device events count: run eagerly, a CPU
    operator (``aten::mm``) also carries the device time of the kernels
    it launched, and the profiler's own buffer markers and the shadows
    of the program's spans (``core/spans.py``) are no work."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or e.key.startswith("ditto.")
                or e.key in ("Command Buffer Full", "Activity Buffer Request",
                             "Buffer Flush")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(t for t, _, _ in rows)
    launched = sum(n for _, n, _ in rows)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"profile_{tag}.txt").write_text("".join(
            f"{t:12.1f} us {n:8d} x  {k}\n" for t, n, k in rows))
    log(f"[{card}] profile {tag}: {n_steps} steps, device "
        f"{total / n_steps:.0f} us/step in {launched / n_steps:.0f} "
        f"kernels/step, wall "
        f"{wall_s * 1e6 / n_steps:.0f} us/step, device busy "
        f"{total / 1e6 / wall_s:.3f} of the wall; top kernels:")
    for t, n, k in rows[:8]:
        log(f"    {t / n_steps:9.1f} us/step  {n // n_steps:5d}/step"
            f"  {k[:90]}")
    cats: dict = {"kernels": launched}
    for t, n, k in rows:
        c = next((c for c, keys in groups
                  if any(key in k for key in keys)), "other")
        cats[c] = cats.get(c, 0.0) + t
    log("    by kind, us/step: " + ", ".join(
        f"{c} {t / n_steps:.1f}" for c, t in
        sorted(cats.items(), key=lambda x: -x[1]) if c != "kernels"))
    return cats


def profile_lm(dev, card: str, cfg, params, n_steps: int,
               out_dir: Path | None) -> None:
    """Trace one yi-9b prefill forward at T = 4096 and n_steps decode
    steps of the engine's 4 lanes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import forward
    from repro_torch.serve import init_cache, make_serve_step

    toks = torch.randint(1, cfg.vocab_size, (1, PREFILL_T), device=dev)
    forward(params, cfg, tokens=toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(params, cfg, tokens=toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, card, "prefill_4k", 1, wall, out_dir)

    step = make_serve_step(cfg)
    lanes = ENGINE["lanes"]
    cache = init_cache(cfg, lanes, 256, dev)
    tok = torch.ones((lanes, 1), dtype=torch.int64, device=dev)
    step(params, cache, tokens=tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tok = step(params, cache, tokens=tok)[0][:, None].long()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, card, "decode_step", n_steps, wall, out_dir)


# ---------------------------------------------------------------------------
# Phases 6-8: the LM serving slice (flash kernel, prefill, engine).
# ---------------------------------------------------------------------------

def flash_inputs(dev, B, T, H, D, n_rep, dtype, seed):
    """q [B, T, H, D]; k and v as repeat_kv's GQA view of [B, T, H/n_rep,
    D] (the main path's form)."""
    import torch
    from repro_torch.models.attention import repeat_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k, v = (repeat_kv(torch.randn(B, T, H // n_rep, D, generator=g,
                                  device=dev).to(dtype), n_rep)
            for _ in range(2))
    return q, k, v


def plain32(q, k, v):
    """The plain version's output before its rounding to q's dtype (it
    computes in f32 whatever the inputs' dtype)."""
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(q.float(), k, v)


def row_err(got, want32) -> float:
    """The largest relative L2 error of one output row (b, t, h)."""
    d = (got.float() - want32).norm(dim=-1) / want32.norm(dim=-1)
    return float(d.max())


def flash_close(tag, got, want32) -> tuple:
    """got against the plain version's f32 output want32: every row
    within FLASH_ROW_TOL, and every element within FLASH_TOL of the plain
    version's own output (want32 in got's dtype).  Returns the max abs
    error and the max row error."""
    import torch
    dt = str(got.dtype).split(".")[-1]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite output")
    w = want32.to(got.dtype).float()
    err = (got.float() - w).abs()
    tol = FLASH_TOL[dt]
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{tag}: max abs error {float(err.max()):.3g} "
                             f"over the tolerance {tol}")
    rows = row_err(got, want32)
    if rows > FLASH_ROW_TOL[dt]:
        raise AssertionError(f"{tag}: a row's relative L2 error {rows:.3g} "
                             f"is over {FLASH_ROW_TOL[dt]:.3g}")
    return float(err.max()), rows


def tiled_attention(q, k, v, fault: str = ""):
    """The kernel's recurrence in plain PyTorch: KV tiles of FLASH_TILE,
    running max, sum and accumulator in f32, the probabilities in q's
    dtype for the P.V product, output in q's dtype.  ``fault`` breaks it
    as a kernel could: "l" leaves the running sum unrescaled when the
    running max grows, "acc_and_l" rescales neither."""
    import torch
    from repro_torch.kernels.ref import gqa_heads
    k, v = gqa_heads(k), gqa_heads(v)
    b, t, h, d = q.shape
    qs = q.float().transpose(1, 2) * d ** -0.5
    m = torch.full((b, h, t), -1e30, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    pos = torch.arange(t, device=q.device)
    for j0 in range(0, t, FLASH_TILE):
        j1 = min(t, j0 + FLASH_TILE)
        s = qs @ k[:, j0:j1].float().permute(0, 2, 3, 1)
        s = s.masked_fill(pos[None, j0:j1] > pos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = (l if fault else l * alpha) + p.sum(-1)
        acc = (acc if fault == "acc_and_l" else acc * alpha[..., None]) + (
            p.to(q.dtype).float() @ v[:, j0:j1].float().transpose(1, 2))
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).to(q.dtype)


def flash_controls(q, k, v, want32) -> dict:
    """The row bound on known outputs of the same inputs: the kernel's
    recurrence done right must pass it; the recurrence with a missing
    rescale, the plain output with every row past the first tile 3% off,
    and the JAX package's bf16 attention (bf16 scores and probabilities)
    must each fail it.  Returns each one's max row error."""
    from repro_torch.models.attention import full_attention
    tol = FLASH_ROW_TOL[str(q.dtype).split(".")[-1]]
    shifted = want32.clone()
    shifted[:, FLASH_TILE:] *= 1 + 2 ** -5
    errs = {name: row_err(o, want32) for name, o in (
        ("recurrence", tiled_attention(q, k, v)),
        ("no_l_rescale", tiled_attention(q, k, v, "l")),
        ("no_rescale", tiled_attention(q, k, v, "acc_and_l")),
        ("late_rows_3pct", shifted.to(q.dtype)),
        ("bf16_scores", full_attention(q, k, v)))}
    if errs["recurrence"] > tol:
        raise AssertionError(f"the kernel's recurrence in PyTorch fails the "
                             f"row bound: {errs}")
    passed = [n for n, e in errs.items() if n != "recurrence" and e <= tol]
    if passed:
        raise AssertionError(f"the row bound {tol:.3g} does not see "
                             f"{passed}: {errs}")
    return errs


def check_flash(dev, card: str, results: dict) -> None:
    """Phase 6."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops, ref

    r = results.setdefault("flash_attention", {})
    cases = [(arch, B, T, H, D, n, dt) for arch, B, T, H, D, n in FLASH_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [("ragged", 1, 1000, 32, 128, 8, dt)
              for dt in (torch.bfloat16, torch.float32)]
    errs, rows = {}, {}
    for i, (arch, B, T, H, D, n_rep, dt) in enumerate(cases):
        q, k, v = flash_inputs(dev, B, T, H, D, n_rep, dt, seed=SEED + i)
        tag = f"flash_attention[{arch}, B={B}, T={T}, H={H}, D={D}, {dt}]"
        want = plain32(q, k, v)
        e, rw = flash_close(tag, ops.flash_attention_op(q, k, v), want)
        errs[dt] = max(errs.get(dt, 0.0), e)
        rows[dt] = max(rows.get(dt, 0.0), rw)
        log(f"{tag}: max abs error {e:.3g}, max row error {rw:.3g} against "
            f"the plain version")
        if arch == "yi-9b" and dt == torch.bfloat16:
            r["controls"] = flash_controls(q, k, v, want)
            log(f"{tag}: row bound {FLASH_ROW_TOL['bfloat16']:.3g} passes "
                f"the recurrence and fails the faults: " + ", ".join(
                    f"{n} {x:.3g}" for n, x in r["controls"].items()))
            # k and v as plain [B, T, H, D] tensors (no view).
            k4, v4 = k.flatten(2, 3).contiguous(), v.flatten(2, 3).contiguous()
            e, rw = flash_close(tag + " plain k/v",
                                ops.flash_attention_op(q, k4, v4),
                                plain32(q, k4, v4))
            errs[dt], rows[dt] = max(errs[dt], e), max(rows[dt], rw)
    r["max_abs_err"] = errs[torch.bfloat16]
    r["max_abs_err_f32"] = errs[torch.float32]
    r["row_err"] = rows[torch.bfloat16]
    r["row_err_f32"] = rows[torch.float32]

    # Timing (the main path's dtype and GQA view): yi-9b at its prefill
    # shape T = 32,768 (the kernels line's numbers) and at T = 4096, and
    # gemma-2b at T = 4096, B = 1.  SDPA gets the same values with k and v
    # as [B, H, T, D] views of materialized heads (made outside the timing).
    # Launched from Python: at tenths of a ms a call and up the host's cost
    # is noise.
    for key, (arch, B, _, H, D, n_rep), T, seed in (
            ("", FLASH_SHAPES[0], PREFILL_LONG_T, 99),
            ("_4k", FLASH_SHAPES[0], PREFILL_T, 98),
            ("_gemma_4k", FLASH_SHAPES[2], PREFILL_T, 97)):
        q, k, v = flash_inputs(dev, B, T, H, D, n_rep, torch.bfloat16, seed)
        if T == PREFILL_LONG_T:
            r["max_abs_err_32k"], r["row_err_32k"] = flash_close(
                f"flash_attention[{arch}, T={T}]",
                ops.flash_attention_op(q, k, v), plain32(q, k, v))
        k4, v4 = k.flatten(2, 3).contiguous(), v.flatten(2, 3).contiguous()
        qt, kt, vt = q.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)

        def sdpa():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)

        n = 5 if T == PREFILL_LONG_T else 20
        ms = eager_ms(lambda: ops.flash_attention_op(q, k, v), n=n)
        plain_ms = eager_ms(lambda: ref.flash_attention_ref(q, k, v), n=2)
        library_ms = eager_ms(sdpa, n=n)
        flops = 2 * B * H * T * T * D          # 0.5 * 4 * B*H*T^2*D, causal
        nbytes = (2 * B * T * H * D + 2 * B * T * (H // n_rep) * D) * 2
        bound_ms = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        by = ("operations" if flops / BF16_FLOP_PER_S
              >= nbytes / HBM_BYTES_PER_S else "bytes")
        r.update({"ms" + key: ms, "plain_ms" + key: plain_ms,
                  "library_ms" + key: library_ms, "bound_ms" + key: bound_ms,
                  "bound_by" + key: by, "flops" + key: flops,
                  "bytes" + key: nbytes})
        log(f"[{card}] flash_attention[{arch}, B={B}, T={T}, H={H}, "
            f"Hkv={H // n_rep}, D={D}] bf16: {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            f"bound {bound_ms:.3f} ms by {by}), plain {plain_ms:.1f} ms, "
            f"SDPA {library_ms:.3f} ms (kernel / SDPA {ms / library_ms:.2f})")
        del q, k, v, k4, v4, qt, kt, vt


def arch_params(dev, arch: str):
    """An arch at full width, random bf16 weights from a seeded generator
    on the card."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{param_count(cfg) / 1e9:.2f}B params "
        f"made on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def flash_layers(cfg) -> int:
    """The layers whose prefill attention is the flash kernel: the causal
    kinds (``attn_local`` takes the plain windowed attention)."""
    kinds = list(cfg.block_pattern) * cfg.n_periods + list(cfg.remainder)
    return sum(k in ("attn", "attn_moe") for k in kinds)


def prefill_input(dev, cfg, t: int, g) -> dict:
    """forward's input of B = 1, T = t, drawn from ``g``: tokens, or for a
    stub frontend (internvl2-1b, musicgen-large) precomputed bf16
    embeddings at the token table's scale (0.02)."""
    import torch
    if cfg.uses_tokens:
        return {"tokens": torch.randint(1, cfg.vocab_size, (1, t),
                                        generator=g, device=dev)}
    return {"embeds": (torch.randn((1, t, cfg.d_model), generator=g,
                                   device=dev) * 0.02).to(torch.bfloat16)}


def run_prefill(dev, card: str, cfg, params, results: dict,
                long_t: bool = True) -> dict:
    """Phase 7 for one arch: T = 4096, and T = 32,768 where ``long_t``.
    The kernels line's launches are yi-9b's (the first arch run); another
    arch's go under keys suffixed with its name."""
    from unittest import mock
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import forward

    g = torch.Generator(device=dev).manual_seed(SEED)
    inp = prefill_input(dev, cfg, PREFILL_T, g)
    n_flash = flash_layers(cfg)
    forward(params, cfg, **inp)                 # warm-up (cuBLAS, kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    h = forward(params, cfg, **inp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = ops.launches()
    if launches["flash_attention"] != n_flash:
        raise AssertionError(f"{cfg.name} prefill launched flash_attention "
                             f"{launches['flash_attention']} times, not "
                             f"{n_flash}")
    r = results["flash_attention"]
    suffix = "" if "launches" not in r else "_" + cfg.name.replace("-", "_")
    r["launches" + suffix] = launches["flash_attention"]
    # Each launch against the plain version on its own in-model inputs.
    kernel, errs = ops.flash_attention_op, []

    def held(q, k, v):
        o = kernel(q, k, v)
        errs.append(flash_close(f"{cfg.name} prefill layer {len(errs)}", o,
                                plain32(q, k, v)))
        return o

    with mock.patch.object(ops, "flash_attention_op", held):
        forward(params, cfg, **inp)
    if len(errs) != n_flash:
        raise AssertionError(f"{cfg.name} prefill: {len(errs)} attention "
                             "calls")

    from repro_torch.models.attention import full_attention
    plain = {}
    for name, fn in (("ref", ref.flash_attention_ref),
                     ("full_attention", full_attention)):
        with mock.patch.object(ops, "flash_attention_op", fn):
            ops.reset_launches()
            plain[name] = forward(params, cfg, **inp).float()
            if ops.launches()["flash_attention"] != 0:
                raise AssertionError("a plain forward launched the kernel")
    if not bool(torch.isfinite(h).all()):
        raise AssertionError(f"{cfg.name} prefill: non-finite hidden "
                             "states")
    h_ref = plain["ref"]
    d = h.float() - h_ref
    rel = float(d.norm() / h_ref.norm())
    rel_full = float((plain["full_attention"] - h_ref).norm() / h_ref.norm())
    table = params["embed" if cfg.tie_embeddings else "unembed"].float()
    lg = h[0, -16:].float() @ table.T
    lg_ref = h_ref[0, -16:] @ table.T
    noise = float((lg - lg_ref).abs().max())
    out = dict(t=PREFILL_T, wall_s=wall, tokens_per_s=PREFILL_T / wall,
               peak_gib=peak / 2**30,
               layer_max_abs_err=max(e for e, _ in errs),
               layer_row_err=max(rw for _, rw in errs),
               rel_l2=rel, rel_l2_full_attention=rel_full,
               max_abs=float(d.abs().max()), logit_noise=noise,
               launches=launches["flash_attention"])
    r["layer_row_err" + suffix] = out["layer_row_err"]
    log(f"[{card}] prefill {cfg.name} T={PREFILL_T}: {wall * 1e3:.1f} ms, "
        f"{PREFILL_T / wall:.0f} tokens/s, peak {peak / 2**30:.2f} GiB, "
        f"flash launches "
        f"{launches['flash_attention']}, each within {out['layer_max_abs_err']:.3g} "
        f"(a row within {out['layer_row_err']:.3g}) of the plain version "
        f"on its inputs; against the plain-attention path "
        f"(f32 softmax): kernel path relative L2 {rel:.3g} (max abs "
        f"{out['max_abs']:.3g}, logits of the last 16 positions up to "
        f"{noise:.3g} apart), full_attention (bf16) path {rel_full:.3g}")
    if not rel <= 2 * rel_full:
        raise AssertionError(f"{cfg.name} prefill: the kernel path is "
                             f"{rel:.3g} from "
                             f"the plain path, over twice the bf16 "
                             f"full_attention path's {rel_full:.3g}")
    del h, h_ref, d, plain
    if not long_t:
        return out

    toks = torch.randint(1, cfg.vocab_size, (1, PREFILL_LONG_T), generator=g,
                         device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    h = forward(params, cfg, tokens=toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launches()["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    if n != n_flash or not bool(torch.isfinite(h).all()):
        raise AssertionError(f"prefill T={PREFILL_LONG_T}: {n} launches, "
                             f"finite {bool(torch.isfinite(h).all())}")
    out.update(long_t=PREFILL_LONG_T, long_wall_s=wall,
               long_tokens_per_s=PREFILL_LONG_T / wall,
               long_peak_mib=peak / 2**20)
    log(f"[{card}] prefill {cfg.name} T={PREFILL_LONG_T}, B=1: {wall:.2f} s, "
        f"{PREFILL_LONG_T / wall:.0f} tokens/s, peak {peak / 2**30:.1f} GiB, "
        f"flash launches {n}")
    return out


def cast_tree(tree, dtype):
    """A param or cache tree with every floating leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def prefill_flops(cfg, t: int) -> float:
    """Model FLOPs of a B = 1 prefill forward of t tokens: 2 a weight a
    token over the active params (``active_param_count``: k of the
    experts), the token tables left out (the forward stops at the final
    norm), and the causal attention of every flash layer (QK^T and PV
    over the t (t + 1) / 2 pairs, 2 FLOPs a multiply-add)."""
    from repro_torch.models import active_param_count
    tables = (1 if cfg.tie_embeddings else 2) * cfg.padded_vocab * cfg.d_model
    n = active_param_count(cfg) - tables
    attn = flash_layers(cfg) * 2 * 2 * cfg.n_heads * cfg.hd * t * (t + 1) / 2
    return 2 * n * t + attn


@contextlib.contextmanager
def timed_calls(module, name: str, spent: list):
    """Patch ``module.name`` so that each call is timed between two device
    syncs (its wall goes to ``spent``)."""
    from unittest import mock
    import torch
    fn = getattr(module, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    with mock.patch.object(module, name, call):
        yield


@contextlib.contextmanager
def counted_ops(module, name: str, ops_of: list):
    """Patch ``module.name`` so that its first call's operators are listed
    in ``ops_of`` (an eager count: the launches of one layer's plain
    torch)."""
    from unittest import mock
    from torch.utils._python_dispatch import TorchDispatchMode
    fn = getattr(module, name)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops_of.append(str(func))
            return func(*args, **(kwargs or {}))

    def call(*a, **kw):
        if ops_of:
            return fn(*a, **kw)
        with Count():
            return fn(*a, **kw)

    with mock.patch.object(module, name, call):
        yield


def zoo_shares(dev, cfg, params, inp) -> dict:
    """One more prefill forward with each of the arch's plain layers timed
    between syncs (the MoE blocks, the RG-LRU scans, the windowed
    attention, the sLSTM loops), each as a share of that forward's wall
    (the syncs add to it); for an MoE arch, a last forward counts one MoE
    block's operators."""
    import torch
    from repro_torch.models import attention, model, rglru, xlstm
    from repro_torch.models import forward
    parts = {"moe": (model, "moe_block"), "rglru_scan": (rglru, "rglru_scan"),
             "windowed_attention": (attention, "full_attention"),
             "slstm_loop": (xlstm, "slstm_scan")}
    kinds = set(cfg.block_pattern)
    want = [k for k, on in (("moe", "attn_moe" in kinds),
                            ("rglru_scan", "rglru" in kinds),
                            ("windowed_attention", "attn_local" in kinds),
                            ("slstm_loop", "slstm" in kinds)) if on]
    spent = {k: [] for k in want}
    with contextlib.ExitStack() as stack:
        for k in want:
            stack.enter_context(timed_calls(*parts[k], spent[k]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(params, cfg, **inp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {f"{k}_share": sum(v) / wall for k, v in spent.items()}
    out.update({f"{k}_calls": len(v) for k, v in spent.items()})
    out["timed_wall_s"] = wall
    if "moe" in want:
        moe_ops: list = []
        with counted_ops(*parts["moe"], moe_ops):
            forward(params, cfg, **inp)
        out["moe_ops"] = len(moe_ops)
    return out


def moe_dropped(cfg, params, inp) -> dict:
    """The share of (token, choice) pairs the capacity dropped over a
    prefill forward, in all and in its first and last MoE layers."""
    from unittest import mock
    from repro_torch.models import forward, moe
    route, seen = moe.moe_route, []

    def counted(*a, **kw):
        r = route(*a, **kw)
        seen.append((int(r.keep.sum()), r.keep.numel()))
        return r

    with mock.patch.object(moe, "moe_route", counted):
        forward(params, cfg, **inp)
    return dict(dropped=1 - sum(k for k, _ in seen) / sum(n for _, n in seen),
                dropped_first_layer=1 - seen[0][0] / seen[0][1],
                dropped_last_layer=1 - seen[-1][0] / seen[-1][1],
                moe_layers=len(seen))


def decoded_logits(dev, cfg, params, toks, f32_caches: bool = False):
    """The f32 logits [T, vocab] of ``toks`` [1, T] decoded one by one
    from a fresh cache: the JAX package's cache dtypes, or every cache
    leaf in f32."""
    import torch
    from repro_torch.serve import init_cache
    from repro_torch.serve.decode import decode_logits
    cache = init_cache(cfg, 1, toks.shape[1], dev)
    if f32_caches:
        cache = cast_tree(cache, torch.float32)
    return torch.cat([decode_logits(params, cfg, cache,
                                    tokens=toks[:, i:i + 1])[0]
                      for i in range(toks.shape[1])])[:, :cfg.vocab_size]


def prefill_logits(cfg, params, toks):
    """The f32 logits [T, vocab] of one prefill forward over ``toks``."""
    from repro_torch.models import forward
    table = params["embed" if cfg.tie_embeddings else "unembed"].float()
    return (forward(params, cfg, tokens=toks)[0].float()
            @ table.T)[:, :cfg.vocab_size]


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def check_recurrent_decode(dev, card: str, cfg, params) -> dict:
    """Phase 16's decode-against-prefill checks of a recurrent arch, on
    ZOO_CHECK_T tokens of one lane.  recurrentgemma-2b (params in f32):
    with f32 caches the decode must equal the prefill within
    ZOO_F32_TOL in relative L2; with the JAX package's caches (bf16 conv
    tail and ring) within twice the bf16 noise, the distance of the bf16
    prefill from the f32 one.  xlstm-350m (JAX decodes it in bf16 only):
    the bf16 decode within twice that noise of the bf16 prefill, the
    argmax equal wherever the prefill's top-two margin exceeds twice the
    position's largest bf16-vs-f32 logit difference; the f32 params with
    f32 caches within ZOO_F32_TOL.  JAX's own criterion (the argmax where
    the margin exceeds 1e-2) is counted and logged."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    toks = torch.randint(1, cfg.vocab_size, (1, ZOO_CHECK_T), generator=g,
                         device=dev)
    p32 = cast_tree(params, torch.float32)
    pre32 = prefill_logits(cfg, p32, toks)
    pre16 = prefill_logits(cfg, params, toks)
    f32_rel = rel_l2(decoded_logits(dev, cfg, p32, toks, f32_caches=True),
                     pre32)
    noise = rel_l2(pre16, pre32)
    out = dict(check_tokens=ZOO_CHECK_T, f32_caches_rel_l2=f32_rel,
               bf16_noise_rel_l2=noise)
    bf16 = cfg.name.startswith("xlstm")
    pre = pre16 if bf16 else pre32
    dec = decoded_logits(dev, cfg, params if bf16 else p32, toks)
    rel = rel_l2(dec, pre)
    top = torch.topk(pre, 2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    flip = dec.argmax(-1) != pre.argmax(-1)
    sure = margin > 2 * (pre16 - pre32).abs().amax(-1)
    jax_sure = margin > 1e-2
    out.update(rel_l2=rel, argmax_checked=int(sure.sum()),
               argmax_flips_checked=int((flip & sure).sum()),
               jax_margin_positions=int(jax_sure.sum()),
               jax_margin_flips=int((flip & jax_sure).sum()))
    kind = "bf16" if bf16 else "f32 params, JAX's"
    log(f"[{card}] {cfg.name} decode of {ZOO_CHECK_T} tokens vs prefill: "
        f"f32 caches relative L2 {f32_rel:.3g} (limit {ZOO_F32_TOL:g}); "
        f"{kind} caches {rel:.3g} (limit {2 * noise:.3g}, twice the bf16 "
        f"prefill's distance from the f32 one); argmax equal at "
        f"{out['argmax_checked'] - out['argmax_flips_checked']} of "
        f"{out['argmax_checked']} positions past twice the bf16 noise, "
        f"{out['jax_margin_flips']} flips of {out['jax_margin_positions']} "
        f"positions past JAX's margin of 1e-2")
    if not f32_rel <= ZOO_F32_TOL:
        raise AssertionError(f"{cfg.name}: the f32 decode is {f32_rel:.3g} "
                             f"from the f32 prefill (limit {ZOO_F32_TOL})")
    if not rel <= 2 * noise:
        raise AssertionError(f"{cfg.name}: the decode is {rel:.3g} from the "
                             f"prefill, over twice the bf16 noise {noise:.3g}")
    if out["argmax_flips_checked"]:
        raise AssertionError(f"{cfg.name}: the decode's argmax differs from "
                             f"the prefill's where the margin is over twice "
                             f"the bf16 noise")
    if not torch.isfinite(dec).all():
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    return out


def zoo_decode(dev, card: str, cfg, params) -> dict:
    """Phase 16's serving figure of a recurrent arch: ZOO_DECODE lanes
    for its steps (bf16 params, the JAX package's cache dtypes), after one
    warm-up step; the cache's bytes at seq_len 4096 and at 32,768 (the
    decode_32k cell's), which must be equal (a 2,048-row ring and O(1)
    recurrent states)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import init_cache
    from repro_torch.serve.decode import decode_logits
    z = ZOO_DECODE
    nbytes = {}
    for seq in (z["seq_len"], 32_768):
        c = init_cache(cfg, z["lanes"], seq, dev)
        nbytes[seq] = tree_bytes(c)
        del c
    if nbytes[z["seq_len"]] != nbytes[32_768]:
        raise AssertionError(f"{cfg.name}: the decode cache grows with "
                             f"seq_len: {nbytes}")
    cache = init_cache(cfg, z["lanes"], z["seq_len"], dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    tok = torch.randint(1, cfg.vocab_size, (z["lanes"], 1), generator=g,
                        device=dev)
    tok = decode_logits(params, cfg, cache, tokens=tok)[:, -1,
                                                        :cfg.vocab_size
                                                        ].argmax(-1)[:, None]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(z["steps"]):
        lg = decode_logits(params, cfg, cache, tokens=tok)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(ops.launches().values()) or not torch.isfinite(lg).all():
        raise AssertionError(f"{cfg.name} decode: a hand-written kernel "
                             f"launched, or non-finite logits")
    n = z["lanes"] * z["steps"]
    out = dict(decode_lanes=z["lanes"], decode_steps=z["steps"],
               decode_wall_s=wall, decode_tokens_per_s=n / wall,
               decode_step_ms=wall * 1e3 / z["steps"],
               cache_bytes=nbytes[z["seq_len"]])
    log(f"[{card}] {cfg.name} decode: {z['lanes']} lanes x {z['steps']} "
        f"steps in {wall:.2f} s = {n / wall:.0f} new tokens/s "
        f"({wall * 1e3 / z['steps']:.1f} ms a step); cache "
        f"{nbytes[z['seq_len']] / 2**30:.3f} GiB at seq_len "
        f"{z['seq_len']} and at 32,768")
    return out


def run_zoo(dev, card: str, results: dict) -> dict:
    """Phase 16: the six archs of the zoo's last slice at full width."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    t_phase = time.perf_counter()
    alloc = torch.cuda.memory_allocated(dev)
    log(f"phase 16: the zoo at full width; {alloc / 2**30:.2f} GiB "
        f"allocated at its start")
    if alloc >= ZOO_START_GIB * 2**30:
        raise AssertionError(f"phase 16 starts with {alloc / 2**30:.2f} GiB "
                             f"allocated (limit {ZOO_START_GIB})")
    out = {}
    for arch in ZOO_ARCHS:
        t_arch = time.perf_counter()
        cfg, params = arch_params(dev, arch)
        g = torch.Generator(device=dev).manual_seed(SEED)
        inp = prefill_input(dev, cfg, PREFILL_T, g)
        if flash_layers(cfg):
            r = run_prefill(dev, card, cfg, params, results, long_t=False)
            r["model_flop_share"] = (prefill_flops(cfg, PREFILL_T)
                                     / r["wall_s"] / BF16_FLOP_PER_S)
            if cfg.n_experts:
                r.update(moe_dropped(cfg, params, inp))
        else:
            forward(params, cfg, **inp)         # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            h = forward(params, cfg, **inp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if any(ops.launches().values()) or not torch.isfinite(h).all():
                raise AssertionError(f"{arch} prefill: {ops.launches()} "
                                     f"launches (0 expected), finite "
                                     f"{bool(torch.isfinite(h).all())}")
            del h
            r = dict(t=PREFILL_T, wall_s=wall, tokens_per_s=PREFILL_T / wall,
                     peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                     launches=0)
            log(f"[{card}] prefill {arch} T={PREFILL_T}: {wall * 1e3:.1f} ms, "
                f"{PREFILL_T / wall:.0f} tokens/s, peak {r['peak_gib']:.2f} "
                f"GiB, 0 hand-written launches")
        r.update(zoo_shares(dev, cfg, params, inp))
        if not flash_layers(cfg):
            r.update(check_recurrent_decode(dev, card, cfg, params))
            r.update(zoo_decode(dev, card, cfg, params))
        r["arch_wall_s"] = time.perf_counter() - t_arch
        log(f"[{card}] phase 16 {arch}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in r.items()
            if isinstance(v, (int, float)) and k != "t"))
        out[arch] = r
        del params, inp
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {len(ZOO_ARCHS)} archs in {out['wall_s']:.1f} s")
    return out


def run_engine(dev, card: str, cfg, params) -> dict:
    """Phase 8."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    from repro_torch.serve import DecodeEngine, init_cache
    from repro_torch.serve.decode import decode_logits

    e = ENGINE
    eng = DecodeEngine(cfg, params, lanes=e["lanes"], page_size=e["page_size"],
                       pool_pages=e["pool_pages"])
    rng = np.random.default_rng(SEED)
    shared = rng.integers(1, cfg.vocab_size, e["shared"])
    for rid in range(e["requests"]):
        tail = rng.integers(1, cfg.vocab_size, e["prompt"] - e["shared"])
        eng.submit(np.concatenate([shared, tail]).astype(np.uint32), e["new"],
                   rid=rid)
    pc = eng.pagecache
    lookups = []                        # (prompt, its answer), in order
    lookup = pc.lookup_or_allocate

    def recorded(prompt):
        answer = lookup(prompt)
        lookups.append((prompt.copy(), answer))
        return answer

    pc.lookup_or_allocate = recorded
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    n_new = sum(len(r.out) for r in done)
    out = dict(requests=len(done), steps=eng.steps, wall_s=wall,
               new_tokens=n_new, tokens_per_s=n_new / wall,
               step_ms=wall * 1e3 / eng.steps, hit_rate=pc.hit_rate,
               evictions=int(pc.stats.evictions), regrets=pc.regrets,
               pages_skipped=sum(r.pages_skipped for r in done),
               launches=launches)
    log(f"[{card}] engine yi-9b: {len(done)} requests, {n_new} new tokens "
        f"in {eng.steps} steps, {wall:.2f} s = {n_new / wall:.1f} new "
        f"tokens/s ({wall * 1e3 / eng.steps:.1f} ms a step of "
        f"{e['lanes']} lanes); prefix hit rate {pc.hit_rate:.3f}, pages "
        f"skipped {out['pages_skipped']}, evictions {out['evictions']}, "
        f"regrets {pc.regrets}, launches {launches}")
    if len(done) != e["requests"] or any(len(r.out) != e["new"]
                                         for r in done):
        raise AssertionError("engine: not every request finished")
    if not (pc.hit_rate > 0 and out["evictions"] > 0):
        raise AssertionError("engine: no prefix hit or no eviction")
    if min(launches[k] for k in CACHE_KERNELS) <= 0:
        raise AssertionError(f"engine: a page-cache kernel never launched: "
                             f"{launches}")
    out["replay"] = replay_page_cache(dev, pc, lookups, launches)

    # Greedy tokens against the prefill forward over prompt + output; the
    # bf16 noise is the largest logit difference between that forward and
    # a one-lane decode replay of the first request's tokens.
    def prefill_logits(req):
        seq = np.concatenate([req.prompt.astype(np.int64), req.out[:-1]])
        tok = torch.from_numpy(seq).to(dev)
        h = forward(params, cfg, tokens=tok[None])
        return tok, (h[0, len(req.prompt) - 1:].float()
                     @ params["unembed"].float().T)[:, :cfg.vocab_size]

    tok, lg = prefill_logits(done[0])
    cache = init_cache(cfg, 1, len(tok) + 1, dev)
    dec = [decode_logits(params, cfg, cache, tokens=tok[i:i + 1, None])
           [0, 0, :cfg.vocab_size] for i in range(len(tok))]
    noise = float((torch.stack(dec[len(done[0].prompt) - 1:]) - lg)
                  .abs().max())
    checked = skipped = 0
    for req in done:
        top = torch.topk(prefill_logits(req)[1], 2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        best = top.indices[:, 0].cpu().numpy()
        sure = margin > 2 * noise
        bad = [i for i in np.nonzero(sure)[0] if best[i] != req.out[i]]
        if bad:
            raise AssertionError(f"engine: request {req.rid}'s greedy tokens "
                                 f"differ from the prefill forward's argmax "
                                 f"at positions {bad}")
        checked += int(sure.sum())
        skipped += int((~sure).sum())
    out.update(greedy_checked=checked, greedy_skipped=skipped,
               logit_noise=noise)
    log(f"engine: greedy tokens equal the prefill forward's argmax at "
        f"{checked} of {n_new} positions; {skipped} near-ties (top-two "
        f"margin <= {2 * noise:.3g}, twice the prefill-vs-decode logit "
        f"difference) skipped")
    if not checked:
        raise AssertionError("engine: no position was checked")
    return out


def replay_page_cache(dev, pc, lookups, launches) -> dict:
    """Phase 8's page-cache check: the engine's lookup stream again,
    through a fresh page cache on the card with each launch of its four
    kernels held against the plain version on the same inputs (at the
    engine's shapes: one key a lookup on a small table whose sample
    windows wrap), and through one on the CPU (the plain versions
    throughout).  Every lookup's answer and the final state must equal
    the engine's: bit for bit on the card; on the CPU, integers bit-equal
    and f32 within 16 ulp (CUDA's expf and powf and the CPU's differ by
    up to 2 ulp a call, and the expert weights compound them)."""
    from unittest import mock
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import DittoPageCache

    def compare_ints(tag, got, want):
        flat = lambda out: [t for o in out
                            for t in (o if isinstance(o, tuple) else (o,))]
        for i, (g, w) in enumerate(zip(flat(got), flat(want))):
            same_int(f"{tag}[{i}]", g, w)

    def compare_cols(tag, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            (same_bits if g.is_floating_point() else same_int)(
                f"{tag}[{i}]", g, w)

    checked = {k: 0 for k in CACHE_KERNELS}
    patches = []
    for name, op, plain, compare in (
            ("access_probe", "access_probe_op", ref.access_probe_ref,
             compare_ints),
            ("ranked_eviction", "ranked_eviction_draw_op",
             ref.ranked_eviction_draw_ref, compare_ints)):
        def held(*args, _name=name, _op=getattr(ops, op), _plain=plain,
                 _compare=compare, **kw):
            got = _op(*args, **kw)
            _compare(f"page cache {_name} launch {checked[_name]}", got,
                     _plain(*args, **kw))
            checked[_name] += 1
            return got
        patches.append(mock.patch.object(ops, op, held))

    # The in-place two: the plain version runs on copies of the columns
    # the kernel is about to write, and the two results must be equal.
    def held_meta(*args, _op=ops.hit_metadata_update_op_):
        want = tuple(a.clone() for a in args[:3])
        ref.hit_metadata_update_ref_(*want, *args[3:])
        _op(*args)
        compare_cols("page cache hit_metadata_update launch "
                     f"{checked['hit_metadata_update']}", args[:3], want)
        checked["hit_metadata_update"] += 1

    def held_scatter(groups, _op=ops.drop_scatter_groups_op_):
        # Each written column once (a column is in several groups).
        cols = list({id(c): c for g in groups for c in g[1]}.values())
        want = {id(c): c.clone() for c in cols}
        ref.drop_scatter_groups_ref(
            [(g[0], tuple(want[id(c)] for c in g[1])) + tuple(g[2:])
             for g in groups])
        _op(groups)
        compare_cols("page cache drop_scatter launch "
                     f"{checked['drop_scatter']}", cols,
                     [want[id(c)] for c in cols])
        checked["drop_scatter"] += 1

    patches += [mock.patch.object(ops, "hit_metadata_update_op_", held_meta),
                mock.patch.object(ops, "drop_scatter_groups_op_",
                                  held_scatter)]

    runs = {}
    for where in (dev, "cpu"):
        rc = DittoPageCache(pc.cfg.capacity, pc.page_size, device=where)
        ops.reset_launches()
        with contextlib.ExitStack() as stack:
            if where == dev:
                for patch in patches:
                    stack.enter_context(patch)
            answers = [rc.lookup_or_allocate(p) for p, _ in lookups]
        runs[str(where)] = rc, answers, ops.launches()
    (card, card_answers, card_launches), (cpu, cpu_answers, _) = (
        runs[str(dev)], runs["cpu"])
    if any(checked[k] != launches[k] or card_launches[k] != launches[k]
           for k in CACHE_KERNELS):
        raise AssertionError(f"page cache replay: {checked} launches held, "
                             f"{card_launches} made, the engine made "
                             f"{launches}")
    for tag, answers in (("card", card_answers), ("cpu", cpu_answers)):
        for i, ((_, want), got) in enumerate(zip(lookups, answers)):
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"page cache replay on the {tag}: "
                                     f"lookup {i} answered {got}, the "
                                     f"engine's {want}")
    engine = (pc.state, pc.clients, pc.stats)
    same_parts("page cache replay on the card", engine,
               (card.state, card.clients, card.stats), 0)
    same_parts("page cache replay on the cpu", engine,
               (cpu.state, cpu.clients, cpu.stats), 16)
    for rc in (card, cpu):
        if (rc.hits, rc.lookups, rc.page_of_key) != (
                pc.hits, pc.lookups, pc.page_of_key):
            raise AssertionError("page cache replay: hits, lookups or "
                                 "pages differ from the engine's")
    log(f"page cache: {len(lookups)} prompts, {pc.lookups} lookups replayed "
        f"on the card ({checked} kernel launches, each equal to the plain "
        f"version on its inputs) and on the CPU: the same answers, hits "
        f"({pc.hits}), evictions, regrets and live keys")
    return dict(prompts=len(lookups), lookups=pc.lookups, held=checked)


# ---------------------------------------------------------------------------
# Phase 14: training at full width.
# ---------------------------------------------------------------------------

def train_flops(cfg, batch: int, seq: int) -> tuple:
    """(model FLOPs, with the remat recompute) of one train step: 2 a
    matmul weight a token and the full [T, T] scores and their product
    with V (the plain attention computes every pair), forward; the
    backward twice the forward; ``remat="full"`` one more forward."""
    d, hd = cfg.d_model, cfg.hd
    per_layer = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
                 + 3 * d * cfg.d_ff)
    matmul = cfg.n_layers * per_layer + cfg.padded_vocab * d
    attn = cfg.n_layers * 2 * 2 * seq * cfg.n_heads * hd
    fwd = 2 * matmul + attn
    tokens = batch * seq
    return 3 * fwd * tokens, 4 * fwd * tokens


def same_opt_step(tag: str, got, want, ocfg, tol: float) -> dict:
    """One train step's (params, opt, loss) against another device's:
    loss, m and v within ``tol`` (abs and rel) at every element; the
    master within it where Adam's normalised step is well conditioned
    (sqrt(v_hat) >= 100 eps) and within the step's reach (2 lr)
    elsewhere, where u = m_hat / (sqrt(v_hat) + eps) turns last-bit
    gradient differences into ones of order one."""
    import numpy as np
    import torch
    from repro_torch.train.optimizer import lr_at, tree_leaves
    (_, go, gl), (_, wo, wl) = got, want
    npf = lambda t: t.detach().float().cpu().numpy()
    if not np.isclose(float(gl), float(wl), rtol=tol, atol=tol):
        raise AssertionError(f"{tag}: loss {float(gl)} vs {float(wl)}")
    step = int(wo.step)
    bc2 = 1 - np.float32(ocfg.b2) ** np.float32(step)
    reach = 2 * float(lr_at(ocfg, torch.tensor(float(step))))
    worst, ill = 0.0, 0
    for part in ("m", "v", "master"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(go, part)),
                                       tree_leaves(getattr(wo, part)))):
            a, b = npf(a), npf(b)
            ok = np.abs(a - b) <= tol + tol * np.abs(b)
            if part == "master":
                v = npf(tree_leaves(wo.v)[i])
                good = np.sqrt(v / bc2) >= 100 * ocfg.eps
                ill += int((~good).sum())
                ok |= ~good & (np.abs(a - b) <= reach + tol)
            if not ok.all():
                raise AssertionError(f"{tag}: {part} leaf {i}: "
                                     f"{int((~ok).sum())} elements off")
            worst = max(worst, float(np.abs(a - b).max()))
    return dict(loss=float(gl), loss_ref=float(wl), max_abs_diff=worst,
                ill_conditioned=ill)


def sdpa_step_s(step, params, opt, batch) -> float:
    """The train step's wall with PyTorch's SDPA (causal; its fused
    backward) in place of ``full_attention``: a yardstick of what a
    fused attention backward would save, as SDPA is phase 6's.  Not on
    any path of the port."""
    import torch
    from unittest import mock
    from repro_torch.kernels.ref import gqa_heads
    from repro_torch.models import attention

    def sdpa(q, k, v, **_):
        k, v = gqa_heads(k), gqa_heads(v)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)

    with mock.patch.object(attention, "full_attention", sdpa):
        float(step(params, opt, batch)[2])              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(params, opt, batch)[2])
        return time.perf_counter() - t0


def smoke_train_step(dev) -> dict:
    """Phase 14: one f32 train step at the smoke config, on the card and
    on the CPU, from the same params (drawn on the CPU) and batch."""
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt, make_train_step
    from repro_torch.train.optimizer import tree_map
    cfg = smoke_config(get_arch(TRAIN["arch"]))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = make_train_step(cfg, ocfg, n_microbatches=2, remat="full")
    cpu = torch.device("cpu")
    params = init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         dtype=torch.float32, device=cpu)
    batch = synthetic_batches(cfg, 8, 32, seed=SEED, device=cpu)(0)
    want = step(params, init_opt(params), batch)
    p_dev = tree_map(lambda t: t.to(dev), params)
    got = step(p_dev, init_opt(p_dev), {k: v.to(dev) for k, v in
                                         batch.items()})
    return same_opt_step("smoke train step, card vs CPU", got, want, ocfg,
                         TRAIN_TOL)


def check_compress(dev, g_flat) -> dict:
    """Phase 14: ``compressed_allreduce(group=None)`` on the whole flat
    gradient on the card; its first COMPRESS_HELD elements (whole blocks)
    bit-equal to the same call on the CPU; every element's error within
    1.01 x its block's scale."""
    import torch
    from repro_torch.train import grad_compress as gc
    n = g_flat.numel()
    t0 = time.perf_counter()
    deq, st = gc.compressed_allreduce(g_flat, gc.init_compress(n, dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    head = g_flat[:COMPRESS_HELD].cpu()
    deq_c, st_c = gc.compressed_allreduce(head, gc.init_compress(
        COMPRESS_HELD))
    same_bits("compress (dequantized)", deq[:COMPRESS_HELD].cpu(), deq_c)
    same_bits("compress (error)", st.error[:COMPRESS_HELD].cpu(), st_c.error)
    pad = (-n) % gc.BLOCK
    scale = torch.nn.functional.pad(g_flat.abs(), (0, pad)).reshape(
        -1, gc.BLOCK).amax(dim=1, keepdim=True) / 127.0
    err = torch.nn.functional.pad((deq - g_flat).abs(), (0, pad)).reshape(
        -1, gc.BLOCK)
    if not bool((err <= 1.01 * scale).all()):
        raise AssertionError("compress: an error above 1.01 x its block's "
                             "scale")
    return dict(elements=n, wall_s=wall, held=COMPRESS_HELD,
                max_err_over_scale=float((err / scale.clamp(min=1e-30))
                                         .max()))


def run_training(dev, card: str, profile: bool = False,
                 out_dir: Path | None = None) -> dict:
    """Phase 14: smollm-135m at full width trains six steps through
    ``TrainLoop`` (checkpoints at 3 and 6), and a second loop resumes
    from step 3's checkpoint to the same params, bit for bit; no
    hand-written kernel launches in a train step, while a prefill
    forward of the same params launches the flash kernel once a layer;
    the smoke step on the card against the CPU; the gradient
    compression on the whole flat gradient.  ``profile``: one more
    step, traced, its device time by kind of kernel."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch.train import adamw_config, synthetic_batches
    from repro_torch.models import forward, param_count
    from repro_torch.train import init_opt, make_train_step
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg, params = arch_params(dev, TRAIN["arch"])
    seq, B = SHAPES["train_4k"].seq_len, TRAIN["batch"]
    ocfg = adamw_config(TRAIN["lr"], TRAIN["steps"])
    step = make_train_step(cfg, ocfg, n_microbatches=TRAIN["microbatches"],
                           remat=TRAIN["remat"])
    batches = synthetic_batches(cfg, B, seq, seed=SEED, device=dev)
    n_params = param_count(cfg)
    log(f"phase 14: {cfg.name} at full width ({n_params:,} params, "
        f"{params['embed'].dtype}), "
        f"global batch {B} x T = {seq} (train_4k's 256 cut to {B}) in "
        f"{TRAIN['microbatches']} microbatches, remat={TRAIN['remat']!r}, "
        f"{TRAIN['steps']} steps, checkpoints every {TRAIN['ckpt_every']}")
    scratch = Path(tempfile.mkdtemp(prefix=".train_ckpt_", dir=ROOT))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        first = TrainLoop(step, str(scratch / "a"),
                          ckpt_every=TRAIN["ckpt_every"])
        p6, o6 = first.run(params, init_opt(params), batches, TRAIN["steps"],
                           log_every=1, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        if any(launches.values()):
            raise AssertionError(f"a train step launched hand-written "
                                 f"kernels: {launches}")
        if sorted(first.mgr._list()) != [3, 6]:
            raise AssertionError(f"checkpoints {first.mgr._list()}")
        (scratch / "b").mkdir()
        for f in ("step_0000000003.npz", "step_0000000003.npz.json"):
            shutil.copy(scratch / "a" / f, scratch / "b" / f)
        t0 = time.perf_counter()
        again = TrainLoop(step, str(scratch / "b"),
                          ckpt_every=TRAIN["ckpt_every"])
        p6b, o6b = again.run(params, init_opt(params), batches,
                             TRAIN["steps"], log_every=1, log=log)
        torch.cuda.synchronize()
        wall_resume = time.perf_counter() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for tag, a, b in (("params", p6, p6b), ("master", o6.master, o6b.master),
                      ("m", o6.m, o6b.m), ("v", o6.v, o6b.v)):
        for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            if not torch.equal(x, y):
                raise AssertionError(f"resume: {tag} leaf {i} differs from "
                                     "the uninterrupted run")
    if again.losses != first.losses[3:]:
        raise AssertionError(f"resume: losses {again.losses} vs "
                             f"{first.losses[3:]}")
    losses = first.losses
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite losses {losses}")
    times = first.straggler.times
    steady = sorted(times[1:])[len(times[1:]) // 2]
    model, hw = train_flops(cfg, B, seq)
    out = dict(arch=cfg.name, params=n_params, batch=B, seq=seq,
               microbatches=TRAIN["microbatches"], remat=TRAIN["remat"],
               losses=losses, step_s=times, step_s_median=steady,
               first_step_s=times[0], tokens_per_s=B * seq / steady,
               peak_gib=peak / 2**30, wall_s=wall, resume_wall_s=wall_resume,
               model_flops=model, hw_flops=hw,
               mfu=model / steady / PEAK_BF16,
               hfu=hw / steady / PEAK_BF16, launches=launches)
    log(f"[{card}] phase 14: {TRAIN['steps']} steps, losses "
        f"{[round(x, 4) for x in losses]}; step times "
        f"{[round(x, 3) for x in times]} s; median after the first "
        f"{steady * 1e3:.1f} ms = {B * seq / steady:,.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; {model:.3e} model FLOPs a step "
        f"({hw:.3e} with the remat recompute) = {out['mfu']:.3f} of "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s ({out['hfu']:.3f}); loop wall "
        f"{wall:.1f} s, resumed run {wall_resume:.1f} s; resume bit-equal; "
        f"hand-written kernel launches in the train steps: 0")

    if profile:
        from torch.profiler import ProfilerActivity, profile as trace
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(p6, o6, batches(TRAIN["steps"]))[2])
            wall_p = time.perf_counter() - t0
        out["profile"] = report_profile(prof, card, "train_step", 1, wall_p,
                                        out_dir, TRAIN_PROFILE_GROUPS)
        out["sdpa_step_s"] = sdpa_step_s(step, p6, o6, batches(TRAIN["steps"]))
        log(f"[{card}] phase 14 yardstick: the same step with PyTorch's "
            f"SDPA (causal, its fused backward) in place of the plain "
            f"attention: {out['sdpa_step_s'] * 1e3:.1f} ms, against "
            f"{steady * 1e3:.1f} ms")
    ops.reset_launches()
    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab_size, (1, PREFILL_T), generator=g,
                         device=dev)
    with torch.no_grad():
        h = forward(p6, cfg, tokens=toks)
    flash = ops.launches()["flash_attention"]
    if flash != cfg.n_layers or not bool(torch.isfinite(h).all()):
        raise AssertionError(f"prefill of the trained params: flash "
                             f"launched {flash} times, not {cfg.n_layers}")
    out["prefill_flash_launches"] = flash

    mb = {k: v[:B // TRAIN["microbatches"]] for k, v in batches(0).items()}
    p_grad = tree_map(lambda x: x.detach().requires_grad_(), p6)
    loss = forward(p_grad, cfg, tokens=mb["tokens"], labels=mb["labels"],
                   remat=TRAIN["remat"])
    grads = torch.autograd.grad(loss, tree_leaves(p_grad))
    g_flat = torch.cat([x.float().reshape(-1) for x in grads])
    del grads, p_grad, loss
    if g_flat.numel() != n_params:
        raise AssertionError(f"flat gradient {g_flat.numel()} != {n_params}")
    out["compress"] = check_compress(dev, g_flat)
    out["smoke_step"] = smoke_train_step(dev)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"phase 14: prefill of the trained params launched flash "
        f"{flash} times (once a layer); compressed_allreduce on the "
        f"{n_params:,}-element gradient in {out['compress']['wall_s']:.3f} s,"
        f" its first {COMPRESS_HELD:,} elements bit-equal to the CPU, "
        f"error <= {out['compress']['max_err_over_scale']:.4f} x its "
        f"block's scale; the smoke step on the card within {TRAIN_TOL} of "
        f"the CPU (max |diff| {out['smoke_step']['max_abs_diff']:.3g}, "
        f"{out['smoke_step']['ill_conditioned']} ill-conditioned master "
        f"elements within 2 lr); phase wall {out['phase_wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the baselines as oracles, and the port's examples.
# ---------------------------------------------------------------------------

def run_oracles(dev, card: str) -> dict:
    """Phase 15: tests/test_adaptive.py's three oracle checks, with the
    cache on the card (``execute(plan=None)``, the fused backend) and
    the baselines on the host, at its sizes and bounds."""
    import numpy as np
    from repro_torch.baselines import PyDitto, simulate_policy
    from repro_torch.core import CacheConfig, execute, make
    from repro_torch.kernels import ops
    from repro_torch.workloads.gen import (interleave, lfu_friendly,
                                           lru_friendly)
    cap, C, n = ORACLE["capacity"], ORACLE["clients"], ORACLE["requests"]
    traces = {"lru": lru_friendly(n, seed=1), "lfu": lfu_friendly(n, seed=1)}

    def card_hit(name, experts):
        cfg = CacheConfig(n_buckets=max(256, cap // 2), assoc=8,
                          capacity=cap, experts=experts)
        res = execute(make(cfg, C, 0, device=dev),
                      interleave(traces[name], C), plan=None)
        return float(res.hits.sum()) / float(res.ops.sum())

    t0 = time.perf_counter()
    ops.reset_launches()
    hit = {(t, e): card_hit(t, e) for t in traces
           for e in (("lru",), ("lfu",), ("lru", "lfu"))}
    launches = ops.launches()
    if not all(launches[k] for k in CACHE_KERNELS):
        raise AssertionError(f"phase 15: the cache kernels did not all "
                             f"launch: {launches}")
    exact = simulate_policy(traces["lru"], cap, "lru")
    if abs(hit["lru", ("lru",)] - exact) >= 0.05:
        raise AssertionError(f"Ditto-LRU {hit['lru', ('lru',)]:.4f} vs exact "
                             f"LRU {exact:.4f}")
    py = {}
    for e in (("lru",), ("lfu",)):
        py[e] = PyDitto(cap, experts=e, seed=0).run(traces["lfu"])
        if abs(py[e] - hit["lfu", e]) >= 0.06:
            raise AssertionError(f"{e}: PyDitto {py[e]:.4f} vs the card "
                                 f"{hit['lfu', e]:.4f}")
    for t in traces:
        best = max(hit[t, ("lru",)], hit[t, ("lfu",)])
        if hit[t, ("lru", "lfu")] < best - 0.03:
            raise AssertionError(f"{t}: adaptive {hit[t, ('lru', 'lfu')]:.4f}"
                                 f" below max(LRU, LFU) {best:.4f} - 0.03")
    out = dict(hit={f"{t}:{'+'.join(e)}": h for (t, e), h in hit.items()},
               exact_lru=exact, pyditto={"+".join(e): h for e, h in
                                          py.items()},
               launches=launches, wall_s=time.perf_counter() - t0)
    log(f"[{card}] phase 15 oracles ({n} requests, capacity {cap}, {C} "
        f"lanes): Ditto-LRU {hit['lru', ('lru',)]:.4f} vs exact LRU "
        f"{exact:.4f}; on the LFU trace Ditto-LRU/LFU "
        f"{hit['lfu', ('lru',)]:.4f}/{hit['lfu', ('lfu',)]:.4f} vs PyDitto "
        f"{py[('lru',)]:.4f}/{py[('lfu',)]:.4f}; adaptive "
        f"{hit['lru', ('lru', 'lfu')]:.4f} (LRU trace), "
        f"{hit['lfu', ('lru', 'lfu')]:.4f} (LFU trace); "
        f"{out['wall_s']:.1f} s")
    return out


def run_examples(card: str, during=None) -> tuple:
    """Phase 15: the five ``examples/torch_*.py`` on the card, each in a
    process of its own, all at once; each must exit 0 (its asserts
    hold).  ``during()`` runs in this process meanwhile (the oracles).
    Returns (the examples' walls, concurrent ones and read no earlier
    than ``during`` returns; what ``during`` returned)."""
    import os
    import shutil
    import subprocess
    import tempfile
    scratch = Path(tempfile.mkdtemp(prefix=".examples_", dir=ROOT))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {}
    try:
        t0 = time.perf_counter()
        for name in EXAMPLES:
            args = ["--ckpt", str(scratch / "ckpt")] if name == "train_lm" \
                else []
            out = open(scratch / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
                 *args], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT), out, time.perf_counter())
        alongside = during() if during is not None else None
        walls, failed, pending = {}, [], dict(procs)
        while pending:
            late = time.perf_counter() - t0 > EXAMPLE_TIMEOUT
            for name, (proc, out, t_start) in list(pending.items()):
                if proc.poll() is None and not late:
                    continue
                if proc.poll() is None:
                    proc.kill()
                rc = proc.wait()
                walls[name] = time.perf_counter() - t_start
                del pending[name]
                out.close()
                text = (scratch / f"{name}.log").read_text()
                tail = "\n    ".join(text.splitlines()[-4:])
                log(f"[{card}] example torch_{name}.py: exit {rc}"
                    f"{' (killed at the time limit)' if late else ''}, "
                    f"{walls[name]:.1f} s\n    {tail}")
                if rc != 0:
                    failed.append(name)
                    log(text[-3000:])
            time.sleep(0.1)
    finally:
        for proc, out, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
        shutil.rmtree(scratch, ignore_errors=True)
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    return dict(wall_s=walls, all_s=time.perf_counter() - t0), alongside


# ---------------------------------------------------------------------
# Phase 17: the mesh, the dry run, the roofline, the audit and the lint
# ---------------------------------------------------------------------

# 17a: cells of the fake-rank dry run over fake CUDA tensors, on both
# production meshes: row 7's prefill (MQA) and the MoE prefill, the
# decode over a sequence-sharded (gemma-2b's one KV head) and a
# head-sharded (musicgen-large) cache, the two recurrent long_500k
# decodes (a batch of one) and one cell cell_supported skips.  The whole
# --all run is in PERF.md, taken on the CPU.
MESH_CELLS = (("gemma-2b", "prefill_32k"), ("olmoe-1b-7b", "prefill_32k"),
              ("gemma-2b", "decode_32k"), ("musicgen-large", "decode_32k"),
              ("recurrentgemma-2b", "long_500k"), ("xlstm-350m", "long_500k"),
              ("yi-9b", "long_500k"))
ROOF_ARCHS = ("yi-9b", "gemma-2b")      # 17b, at B = 1, T = ROOF_T
ROOF_T = 4096
# PERF.md's hand-worked bound of one flash call at ROOF_T, us.
ROOF_FLASH_US = {"yi-9b": 139.0, "gemma-2b": 69.5}
ROOF_FLOOR = 0.95       # a measured time under this share of its bound fails
# 17c: phase 14's config with fewer microbatches.
MESH_TRAIN = dict(batch=4, microbatches=2)


def ms_events(fn, reps: int = 3) -> float:
    """Wall of one call between CUDA events, the best of ``reps`` after
    one warm call (for calls too large to capture in a graph)."""
    import torch
    fn()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def card_rates(dev) -> dict:
    """The card's achieved dense bf16 matmul rate (8192^3) and copy
    bandwidth (a 2 GiB copy: read and write), beside the spec sheet's."""
    import torch
    from repro_torch.launch import roofline as rl
    n = 8192
    a = torch.randn(n, n, device=dev).to(torch.bfloat16)
    b = torch.randn(n, n, device=dev).to(torch.bfloat16)
    mm = time_ms(lambda: a @ b, n=5, reps=4)
    src = torch.empty(1 << 30, dtype=torch.int16, device=dev)
    dst = torch.empty_like(src)
    cp = time_ms(lambda: dst.copy_(src), n=2, reps=4)
    out = dict(matmul_tflops=2 * n ** 3 / (mm * 1e-3) / 1e12,
               copy_tb_s=2 * src.numel() * 2 / (cp * 1e-3) / 1e12,
               spec_tflops=rl.PEAK_FLOPS / 1e12, spec_tb_s=rl.HBM_BW / 1e12)
    del a, b, src, dst
    torch.cuda.empty_cache()
    return out


def counter_bounds(device: str = "cuda") -> dict:
    """The op counter's bound of one call of each kernel at phase 2's
    main-path shapes (a 2,097,152-slot table, B = 2048, K = 5, E = 2)
    and row 7 at yi-9b's T = 32,768 and 4096 and gemma-2b's 4096 (B = 1,
    bf16), on fake tensors: the larger of its FLOPs over the bf16 peak
    and its op bytes (every operand read whole, every result written)
    over HBM's rate, us."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models.attention import repeat_kv
    n, B, k, W = N_BUCKETS * ASSOC, 2048, 5, 20
    out = {}
    with FakeTensorMode():
        i64 = lambda *s: torch.empty(s, dtype=torch.int64, device=device)
        f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
        flag = torch.empty(B, dtype=torch.bool, device=device)
        cols = [i64(n) for _ in range(8)]
        calls = {
            "access_probe": lambda: ops.access_probe_op(
                *cols[:4], i64(B), i64(), assoc=ASSOC, history_len=CAPACITY,
                meta=tuple(cols[4:7]), ts=i64(B), experts=("lru", "lfu")),
            "hit_metadata_update": lambda: ops.hit_metadata_update_op_(
                cols[0], cols[1], f32(n, 4), i64(B), i64(B), i64(B), i64(B)),
            "ranked_eviction": lambda: ops.ranked_eviction_draw_op(
                *cols[:4], i64(LANES, 2), f32(LANES, 2), flag, i64(B), i64(B),
                window=W, k=k, experts=("lru", "lfu")),
            "drop_scatter": lambda: ops.drop_scatter_groups_op_((
                (i64(B), (cols[0],), (i64(B),)),
                (i64(B), tuple(cols[:8]), tuple(i64(B) for _ in range(8)),
                 flag),
                (i64(B * k), (cols[1],), (0,)))),
            "sampled_eviction": lambda: ops.sampled_eviction_op(
                *(f32(n + W) for _ in range(4)), i64(B), i64(B), 1.0,
                window=W, k=k),
            "bucket_lookup": lambda: ops.bucket_lookup_op(
                cols[0], cols[1], i64(B), assoc=ASSOC),
            "metadata_update": lambda: ops.metadata_update_op(
                f32(n), f32(n), i64(B), f32(B), 1.0),
        }
        for tag, (T, H, hkv, D) in (("yi-9b 32k", (32768, 32, 4, 128)),
                                    ("yi-9b 4k", (4096, 32, 4, 128)),
                                    ("gemma-2b 4k", (4096, 8, 1, 256))):
            q = torch.empty(1, T, H, D, dtype=torch.bfloat16, device=device)
            kv = repeat_kv(torch.empty(1, T, hkv, D, dtype=torch.bfloat16,
                                       device=device), H // hkv)
            calls[f"flash_attention {tag}"] = (
                lambda q=q, kv=kv: ops.flash_attention_op(q, kv, kv))
        for name, fn in calls.items():
            with OpCounter() as c:
                fn()
            out[name] = max(c.flops / rl.PEAK_FLOPS,
                            c.bytes / rl.HBM_BW) * 1e6
    return out


def mesh_prefill(dev, card: str, arch: str, mesh) -> dict:
    """17b (and 17c's prefill at gemma-2b): the prefill forward at B = 1,
    T = ROOF_T with DTensor params on the one-rank mesh, under the op
    counter: the counted FLOPs of each flash call against PERF.md's
    hand-worked bound; the forward's and one flash call's measured times
    against their roofline bounds; the flash kernel's launches under
    DTensor; the hidden states against the same forward without a mesh,
    bit for bit."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import forward
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import active_param_count, build_param_specs
    cfg, params = arch_params(dev, arch)
    g = torch.Generator(device=dev).manual_seed(SEED)
    inp = prefill_input(dev, cfg, ROOF_T, g)
    with torch.no_grad():
        want = forward(params, cfg, **inp)
        fwd_ms = ms_events(lambda: forward(params, cfg, **inp))
        specs = build_param_specs(cfg, model_shards=1)
        with sh.use_mesh(mesh):
            dp = sh.distribute_tree(params, specs, mesh)
            din = {k: sh.distribute(v, sh.P(*([None] * v.dim())), mesh)
                   for k, v in inp.items()}
            torch.cuda.synchronize()
            ops.reset_launches()
            with OpCounter() as c:
                got = forward(dp, cfg, **din)
            torch.cuda.synchronize()
            launches = ops.launches()["flash_attention"]
            got = got.full_tensor()
    if launches != flash_layers(cfg):
        raise AssertionError(f"phase 17 {arch}: the flash kernel launched "
                             f"{launches} times under DTensor, not "
                             f"{flash_layers(cfg)}")
    if not torch.equal(got, want):
        raise AssertionError(f"phase 17 {arch}: the mesh prefill differs "
                             "from the plain one: max |d| "
                             f"{(got.float() - want.float()).abs().max():.3g}")
    calls, flops, _ = c.by_op["ditto.flash_attention.default"]
    flash_us = flops / calls / rl.PEAK_FLOPS * 1e6
    if abs(flash_us / ROOF_FLASH_US[arch] - 1) > 0.005:
        raise AssertionError(f"phase 17 {arch}: the counter's flash bound "
                             f"{flash_us:.2f} us is not PERF.md's "
                             f"{ROOF_FLASH_US[arch]} us")
    roof = rl.analyze(c.report(), 1,
                      2.0 * active_param_count(cfg) * ROOF_T)
    bound_ms = roof.step_time * 1e3
    from repro_torch.models.attention import repeat_kv
    q = torch.randn(1, ROOF_T, cfg.n_heads, cfg.hd, device=dev,
                    dtype=torch.bfloat16)
    kv = repeat_kv(torch.randn(1, ROOF_T, cfg.n_kv_heads, cfg.hd, device=dev,
                               dtype=torch.bfloat16),
                   cfg.n_heads // cfg.n_kv_heads)
    flash_ms = time_ms(lambda: ops.flash_attention_op(q, kv, kv))
    for what, ms, b in (("forward", fwd_ms, bound_ms),
                        ("flash call", flash_ms, flash_us / 1e3)):
        if ms < ROOF_FLOOR * b:
            raise AssertionError(f"phase 17 {arch}: the {what} took {ms:.4f}"
                                 f" ms, under {ROOF_FLOOR} of its roofline "
                                 f"bound {b:.4f} ms: the counter missed work")
    out = dict(fwd_ms=fwd_ms, bound_ms=bound_ms, bottleneck=roof.bottleneck,
               flops=roof.flops_per_device,
               fused_bytes=roof.fused_bytes_per_device,
               bytes=roof.bytes_per_device, flash_ms=flash_ms,
               flash_bound_ms=flash_us / 1e3, flash_launches=launches,
               mfu_bound=roof.mfu_bound)
    log(f"[{card}] phase 17b {arch} prefill B=1 T={ROOF_T} on the one-rank "
        f"mesh: forward {fwd_ms:.3f} ms against a roofline bound of "
        f"{bound_ms:.3f} ms ({roof.bottleneck}: {roof.flops_per_device:.4g}"
        f" FLOPs, {roof.fused_bytes_per_device:.4g} fused bytes, "
        f"{roof.bytes_per_device:.4g} op bytes), {bound_ms / fwd_ms:.3f} of "
        f"it; one flash call {flash_ms * 1e3:.1f} us against the counter's "
        f"{flash_us:.2f} us (PERF.md {ROOF_FLASH_US[arch]}); {launches} "
        "flash launches under DTensor; hidden states bit-equal to the "
        "plain forward")
    del params, dp, q, kv
    torch.cuda.empty_cache()
    return out


def mesh_train(dev, card: str, mesh) -> dict:
    """17c: one smollm-135m train step at phase 14's config with fewer
    microbatches, with DTensor params and the ZeRO-1 specs live on the
    one-rank mesh, against the same step without a mesh: params,
    optimizer state and loss bit for bit."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch.train import adamw_config, synthetic_batches
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_param_specs
    from repro_torch.train import init_opt, make_train_step, zero_specs
    from repro_torch.train.optimizer import tree_leaves
    cfg, params = arch_params(dev, TRAIN["arch"])
    seq, B = SHAPES["train_4k"].seq_len, MESH_TRAIN["batch"]
    ocfg = adamw_config(TRAIN["lr"], TRAIN["steps"])
    batch = synthetic_batches(cfg, B, seq, seed=SEED, device=dev)(0)
    kw = dict(n_microbatches=MESH_TRAIN["microbatches"],
              remat=TRAIN["remat"])
    t0 = time.perf_counter()
    want = make_train_step(cfg, ocfg, **kw)(params, init_opt(params), batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    specs = build_param_specs(cfg, model_shards=1)
    zspecs = zero_specs(specs, params, mesh)
    step = make_train_step(cfg, ocfg, param_specs=specs, zspecs=zspecs, **kw)
    with sh.use_mesh(mesh):
        dp = sh.distribute_tree(params, specs, mesh)
        db = {k: sh.distribute(v, sh.P("dp", None), mesh)
              for k, v in batch.items()}
        t0 = time.perf_counter()
        got = step(dp, init_opt(dp, zspecs), db)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    pairs = [("loss", got[2], want[2]), ("opt.step", got[1].step,
                                          want[1].step)]
    for part, i in (("params", 0), ("master", 1), ("m", 2), ("v", 3)):
        g_t = got[0] if i == 0 else got[1][i]
        w_t = want[0] if i == 0 else want[1][i]
        pairs += [(part, a, b) for a, b in zip(tree_leaves(g_t),
                                               tree_leaves(w_t))]
    bad = [(n, (full(a).float() - b.float()).abs().max().item())
           for n, a, b in pairs if not torch.equal(full(a), b)]
    if bad:
        raise AssertionError(f"phase 17c: the mesh train step differs from "
                             f"the plain one at {len(bad)} of {len(pairs)} "
                             f"leaves, e.g. {bad[:3]}")
    log(f"[{card}] phase 17c: {cfg.name} train step (batch {B}, T {seq}, "
        f"{kw['n_microbatches']} microbatches, remat {kw['remat']}) with "
        f"DTensor params and ZeRO-1 specs on the one-rank mesh: {mesh_s:.2f} s"
        f" (plain {plain_s:.2f} s); loss, params and optimizer state "
        f"({len(pairs)} leaves) bit-equal to the plain step")
    del params, dp, want, got
    torch.cuda.empty_cache()
    return dict(mesh_s=mesh_s, plain_s=plain_s, leaves=len(pairs))


def run_mesh(dev, card: str) -> dict:
    """Phase 17: (a) the fake-rank dry run of MESH_CELLS on both
    production meshes over fake CUDA tensors (any ``failed`` cell fails);
    (b) the roofline against the card at ROOF_ARCHS (``mesh_prefill``)
    with the card's achieved rates; (c) the mesh path on the one-rank
    mesh (``mesh_train``, and (b)'s gemma-2b prefill under DTensor); (d)
    the graph audit over CUDA tensors (only the mirrored dead outputs);
    (e) the lint of the shipped tree (no finding)."""
    import torch
    from repro_torch.analysis import astlint, audit
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch import roofline as rl

    t_phase = time.perf_counter()
    out: dict = {}
    t0 = time.perf_counter()
    try:
        recs = dryrun.run_cells(MESH_CELLS, ("single", "multi"),
                                device_type="cuda", save=False, log=log)
    finally:
        M.teardown()
    failed = [r for r in recs if r["status"] == "failed"]
    if failed:
        raise AssertionError(f"phase 17a: {len(failed)} dry-run cells "
                             f"failed: {[r['error'] for r in failed]}")
    out["dryrun"] = [{k: r.get(k) for k in (
        "arch", "shape", "mesh", "status", "run_s", "peak_hbm_per_dev",
        "flops_per_dev", "bottleneck", "kernel_calls")} for r in recs]
    log(f"phase 17a: {sum(r['status'] == 'ok' for r in recs)} cells ok, "
        f"{sum(r['status'] == 'skipped' for r in recs)} skipped, over fake "
        f"CUDA tensors, in {time.perf_counter() - t0:.1f} s")

    out["counter_bounds_us"] = b = counter_bounds()
    log("phase 17b: the op counter's bound of one call of each kernel at "
        "phase 2's shapes (FLOPs at the bf16 peak, or every operand and "
        "result's bytes at HBM's rate), us: "
        + ", ".join(f"{k} {v:.3f}" for k, v in b.items()))
    out["rates"] = r = card_rates(dev)
    log(f"[{card}] phase 17b: bf16 matmul {r['matmul_tflops']:.1f} TFLOP/s "
        f"(spec sheet {r['spec_tflops']:.0f}), copy {r['copy_tb_s']:.3f} "
        f"TB/s (spec sheet {r['spec_tb_s']:.2f}); roofline constants "
        f"{rl.CARD}")
    mesh = M.make_card_mesh(dev.index or 0)
    try:
        out["prefill"] = {a: mesh_prefill(dev, card, a, mesh)
                          for a in ROOF_ARCHS}
        out["train"] = mesh_train(dev, card, mesh)
    finally:
        M.teardown()

    t0 = time.perf_counter()
    found = audit.audit_entry_points(device="cuda")
    if not audit.mirrored(found):
        extra = [str(f) for f in found if not audit.mirrored([f])]
        raise AssertionError(f"phase 17d: the audit found {extra}")
    out["audit"] = dict(mirrored=len(found), s=time.perf_counter() - t0)
    log(f"phase 17d: the graph audit over CUDA tensors: {len(found)} "
        "findings, all the mirrored dead outputs of run_trace_grouped, in "
        f"{out['audit']['s']:.1f} s")
    lint = astlint.lint_paths([SRC / "repro_torch"])
    if lint:
        raise AssertionError(f"phase 17e: lint findings: "
                             f"{[str(f) for f in lint]}")
    log("phase 17e: the lint of src/repro_torch: 0 findings")
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17: wall {out['wall_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=6_000_000)
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", type=int, default=0,
                    help="also trace this many grouped steps per backend "
                         "and twice as many (the difference is the step "
                         "alone) of phases 3, 9 and 10 (phase 11: fused "
                         "DM steps), one yi-9b prefill and 8 decode steps, "
                         "and one phase-14 train step")
    ap.add_argument("--dm-only", default=None, const="", nargs="?",
                    metavar="TAG",
                    help="only run phase 11's fused run cold and warm with "
                         "host and device timing, its lines prefixed with "
                         "TAG (it runs on an older checkout's src/ too)")
    ap.add_argument("--ranks-only", action="store_true",
                    help="only run phases 11, 12 and 13 (a) and (b), which "
                         "phase 18 is held to, then phase 18 (the pool "
                         "across ranks): no result lines")
    ap.add_argument("--step-only", action="store_true",
                    help="only plan phase 3's trace, count one eager step's "
                         "operators per backend and, with --profile, trace "
                         "the steps: no kernel check and no result lines "
                         "(it runs on an older checkout's src/ too)")
    a = ap.parse_args()

    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import runtime
    card = runtime.device_line(dev)
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    runtime.lib()
    log(f"built {len(runtime.sources())} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")
    if a.dm_only is not None:
        dm_cold_warm(dev, card, a.dm_only and a.dm_only + " ")
        return 0
    if a.ranks_only:
        results = {k: {} for k in CACHE_KERNELS}
        keep = {n: {} for n in ("11", "12", "13")}
        _, cluster, keys11 = run_dm(dev, card, results, keep=keep["11"])
        run_failover(dev, card, results, keep=keep["12"])
        run_elastic(dev, card, results, cluster, keys11, keep=keep["13"])
        del cluster
        run_ranks(dev, card, results, *keep.values())
        return 0
    if a.step_only:
        from repro_torch.core import CacheConfig
        k2, w2, T, gp, _ = plan_trace(a.requests, 0)
        check_step_traffic(dev, CacheConfig(n_buckets=N_BUCKETS, assoc=ASSOC,
                                            capacity=CAPACITY), gp,
                           strict=False)
        if a.profile:
            profile_steps(dev, card, gp, k2[:T], a.profile, None)
        return 0

    results: dict = {}
    reductions = check_reductions(dev)
    floor_ms = check_kernels(dev, results)
    e2e, plan, trace = run_main_path(dev, card, a.requests, SEQ_ROUNDS,
                                     results)
    e2e["reductions"] = reductions
    if a.profile:
        profile_steps(dev, card, plan, trace, a.profile,
                      Path(a.out).parent if a.out else None)

    check_flash(dev, card, results)
    cfg, params = arch_params(dev, "yi-9b")
    e2e["prefill"] = run_prefill(dev, card, cfg, params, results)
    e2e["engine"] = run_engine(dev, card, cfg, params)
    if a.profile:
        profile_lm(dev, card, cfg, params, 8,
                   Path(a.out).parent if a.out else None)
    del params
    torch.cuda.empty_cache()
    cfg, params = arch_params(dev, "gemma-2b")
    e2e["prefill_gemma_2b"] = run_prefill(dev, card, cfg, params, results,
                                          long_t=False)
    del params
    torch.cuda.empty_cache()
    e2e["zoo"] = run_zoo(dev, card, results)
    prof_dir = Path(a.out).parent if a.out else None
    e2e["tenants"] = run_tenants(dev, card, results, a.profile, prof_dir)
    e2e["l0"] = run_l0(dev, card, results, a.profile, prof_dir)
    keep = {n: {} for n in ("11", "12", "13")}
    e2e["dm"], cluster, keys11 = run_dm(dev, card, results, a.profile,
                                        prof_dir, keep=keep["11"])
    e2e["failover"] = run_failover(dev, card, results, keep=keep["12"])
    e2e["elastic"] = run_elastic(dev, card, results, cluster, keys11,
                                 a.profile, prof_dir, keep=keep["13"])
    del cluster
    torch.cuda.empty_cache()
    e2e["ranks"] = run_ranks(dev, card, results, *keep.values())
    del keep
    torch.cuda.empty_cache()
    e2e["train"] = run_training(dev, card, bool(a.profile), prof_dir)
    torch.cuda.empty_cache()
    e2e["examples"], e2e["oracles"] = run_examples(
        card, lambda: run_oracles(dev, card))
    torch.cuda.empty_cache()
    e2e["mesh"] = run_mesh(dev, card)

    replaces = {
        "access_probe": "src/repro/kernels/bucket_lookup.py:171",
        "hit_metadata_update": "src/repro/kernels/metadata_update.py:154",
        "ranked_eviction": "src/repro/kernels/sampled_eviction.py:215",
        "flash_attention": "src/repro/kernels/flash_attention.py:88",
        "sampled_eviction": "src/repro/kernels/sampled_eviction.py:251",
        "bucket_lookup": "src/repro/kernels/bucket_lookup.py:98",
        "metadata_update": "src/repro/kernels/metadata_update.py:184",
        # No Pallas kernel: XLA's in-place drop-mode scatters of the apply.
        "drop_scatter": "src/repro/core/cache.py:636"}
    extra = ("eager_ms", "copy_ms", "copy_bound_ms", "wrapper_ms",
             "ms_alone", "bound_ms_alone", "ms_insert_group",
             "bound_ms_insert_group", "ms_given", "plain_ms_given",
             "bound_ms_given",
             "max_abs_err_f32", "max_abs_err_32k", "row_err", "row_err_f32",
             "row_err_32k", "controls", "layer_row_err", "ms_pairs",
             "ms_one_slot", "ms_one_tile", "wrapper_bound_ms", "ms_65k",
             "bound_ms_65k", "wrapper_ms_65k", "wrapper_bound_ms_65k",
             "launches_gemma_2b", "layer_row_err_gemma_2b", "ms_tenant",
             "plain_ms_tenant", "bound_ms_tenant", "ms_w128",
             "launches_tenants", "launches_l0", "launches_dm",
             "launches_failover", "launches_elastic", "launches_ranks",
             *(f"{k}_{a.replace('-', '_')}" for a in ZOO_ARCHS
               for k in ("launches", "layer_row_err")),
             *(f + k for k in ("_4k", "_gemma_4k") for f in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")))
    kernels = []
    for name, r in results.items():
        by = r.get("bound_by", "bytes")
        log(f"[{card}] {name}: {r['ms'] * 1e3:.1f} us (bound "
            f"{r['bound_ms'] * 1e3:.2f} us by {by}), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, launches {r['launches']}")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces[name], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=by, library_ms=r.get("library_ms"), floor_ms=floor_ms,
            **{k: r[k] for k in extra if k in r}))
    if a.out:
        out = Path(a.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, kernels=kernels, e2e=e2e),
                                  indent=1, default=float))
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.0f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
