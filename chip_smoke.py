#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's main path, the paper's Table-3 sweep
(``repro_torch.sim.run_sweep``), on the card and checks it:

1. build   — compiles every CUDA kernel from ``src/repro_torch/csrc`` into
             ``build/`` (one ``nvcc`` per source, all at once).
2. kernel  — the Lookahead greedy kernel against its plain PyTorch version
             on the card at the sweep's shapes (n=16, U=256, f64;
             concave, nonmonotone and flat curves; plain and masked), and
             on the very inputs each path hands the kernel at its first
             call (captured from the path, which stops there): the
             4096-mix sweep in buckets and as one table, the segment
             backend, each Fig. 12 grid (U=512 among them) and the scalar
             plant on w1 and on the Fig. 1 pair (B=1, n=2, U=64), the
             training plant's first boundary (B=1, n=12, U=96), the
             streaming sweep's first chunk at full width (B=512, n=16) and
             the serving device engine's first reconfiguration at phase
             15(b)'s configuration (B=1, n=4, U=256):
             ``alloc`` and ``balance`` must be exactly equal.  Prints the
             kernel's and the plain version's times and the kernel's bound.
3. sweep   — all 14 managers over ``random_mixes(32, 16, seed=1)``, 100 ms:
             the geomean weighted speedups must equal the reference table
             to 4 decimals, the discrete outputs must equal the port's own
             CPU run exactly and the floats within rtol 1e-9, the stacked
             run must equal the per-manager ("fused") run bit for bit, and
             the greedy kernel must have launched.
4. scale   — the same 14 managers over ``random_mixes(4096, 16, seed=1)``
             (57,344 stacked rows): warm wall time, mixes/s, greedy
             launches and the kernel's share of the wall time; its first
             32 mixes must reproduce phase 3.

Phases 3 and 4 run the timeline in length buckets (the default) and
again as one stacked table: the two must be bit-identical, and both walls
and greedy launch counts are printed beside the last ones measured
before the buckets.  Each adds one
profiled sweep for the device time by kernel and the card's busy share
(device time over the unprofiled warm wall).

The host-coordinated paths, each with the launch counts reset just
before it and read just after:

7. segment — the 14 managers over the 4096 mixes on the segment backend
             (one model evaluation per Fig. 8 segment), held to phase 4's
             stacked run: cache units and prefetch settings equal, IPC
             within rtol 1e-9, bandwidth within rtol 1e-12.
8. grid    — Fig. 12's CBP grids over the 4096 mixes, one
             ``run_sweep(param_grid=...)`` each (reconfiguration interval
             1/10/100 ms, minimum bandwidth 0.5/1.0 GB/s, sampling period
             0.25/0.5/1.0 ms, 512 units with 4 more LLC cycles): capacity
             invariants, and the first 32 mixes of each slice against
             ``run_sweep(params=p)``; walls, launches and peak memory.
9. managers — ``run_all_managers`` on the scalar plant for w1 and the
             Fig. 1 pair (lbm + xalancbmk, 64 units, 16 GB/s), 100 ms:
             weighted speedups within rtol 1e-9 of the reference's.
10. characterization — Figs. 2-4 on the card: the Fig. 2 class counts,
             the named values within rtol 1e-9 of the reference's, the
             whole table within rtol 1e-9 of the port's CPU run.
11. plant  — the training-loop binding, for every case of the committed
             ``tests/data/plant_golden.json`` (``tools/plant_golden.py``:
             the cases of ``tests/test_plant_jax.py``, both
             ``runtime_bench`` shapes and its full shape at 4,000 ms): the
             fused Fig. 8 knob schedule
             (``repro_torch.runtime.plant.run_fused_schedule``) bit for
             bit against the reference's golden and the port's CPU run,
             each warm run exactly one CUDA-graph replay with the greedy
             launches it captured; ``host_reference_run`` on the card,
             discrete fields exact and floats within rtol 1e-12; walls of
             the eager warm-up, the capture, the warm replays (median of
             10) and the host golden.
12. static — Fig. 5's static search
             (``repro_torch.sim.static_search.search_static``) against the
             reference's numpy golden, the committed
             ``tests/data/static_search_golden.json``
             (``tools/static_search_golden.py``): ``fig5_smoke``'s
             configuration (16 workloads x 4 apps, seed 7, the six Fig. 5
             families, k = 3; cold and warm walls, peak memory,
             ``geo_all3`` rounding to the record's 1.269), the same
             workloads over the registry's 14 families (the banked ``bank
             bw`` among them), ``fig5_potential``'s 640-workload study
             (k = 1; warm wall, peak memory, chunks per family, geomeans,
             the fraction at 1.10 and all-three over the best pair beside
             the golden's) and the reference's Pareto case (3 x 2, k = 6).
             Every top-k index equals the golden's or names its twin (the
             same allocation of the same applications under a permutation
             of equal-named positions, from names and grid rows: they tie
             in exact arithmetic, in the banked regime too), twin picks
             counted per family; on the smoke workloads each family's
             top-k equals the stable descending argsort of the card's own
             scores of the whole grid, bit for bit; weighted speedups
             within rtol 1e-5 of the golden, the Pareto case's indices
             equal and its floats within 1e-12; the greedy launches
             nothing.
13. stream — the fault-tolerant streaming sweep
             (``repro_torch.sim.stream_sweep.run_stream``) against the
             reference's float64 aggregates, the committed
             ``tests/data/stream_golden.json`` (``tools/stream_golden.py``):
             ``stream_bench.py``'s smoke configuration (64 mixes in chunks
             of 16, ``baseline`` and ``CBP``, 20 ms, zipf): overlapped and
             serial, bit for bit equal, CBP's geomean rounding to the
             record's 1.401397, the kill-free fault plan against the
             golden, and the resume-parity gate (a dispatch error at chunk
             0, NaN poison at chunk 1, a kill at chunk 2, resumed from a
             checkpoint in a temporary directory: bit for bit the clean
             run's, chunk 1 quarantined at coverage 0.75); then the first
             24 chunks of ``stream_bench.py::full``'s stream (12,288 mixes
             in chunks of 512 x 16 apps, 50 ms, a diurnal period of 24
             chunks): serial and overlapped, bit for bit equal, warm walls
             and mixes/s, greedy launches 24 times those of the first
             chunk's ``run_timelines`` alone, and peak device memory at
             most 1.10 times that of the stream's 1-chunk prefix.  Counts
             exact (``mix_count``, ``slowdown_hist``, quarantined chunks,
             coverage, retries), the float aggregates within rtol 1e-9;
             every healthy run at coverage 1.0 with no retry.

14. models — the model stack (``repro_torch.models``,
             ``repro_torch.configs``), which calls no hand-written kernel
             (neither do the reference's models): (a) every smoke config
             built from a seed on the CPU and copied to the card, float32
             with TF32 off: loss, prefill and 12 decode steps (qwen3-8b's
             also with a per-row ``cur_len``) within rtol 1e-4 and atol
             1e-5 of the port's CPU run, or 4 times the CPU run's own
             one-ulp spread where that passes 1e-5 (zamba2-7b, ROADMAP R4);
             MoE routing and the kept-slot table exactly equal, also at
             capacity factor 0.5 where every expert overflows (R3); (b)
             qwen3-8b at its full config (bf16, 36 layers): prefill of 4 x
             2,048 tokens, the cache filled with the prompt's K/V, the
             last prompt token decoded at position 2,047 against the
             prefill, 32 greedy steps against a cache of 2,080 positions
             (8 more under the profiler: the card's busy share), decode
             against the forward on the first 16 positions; walls,
             tokens/s and peak memory; (c) the other nine at full width
             cut in depth (2 layers, zamba2-7b 7, whisper-tiny whole;
             mamba2 and zamba2 in SSD chunks of 16, R5): prefill and 8
             decode steps, finite, decode against the forward (bf16; MoE
             also in float32, zamba2-7b in float32 alone).  The launch
             counts stay 0.
15. serve  — the serving path (``repro_torch.serving``): (a) the fixtures
             of the reference's ``tests/test_serving_jax.py`` with the
             qwen3-8b smoke model (float32, built on the CPU and moved):
             the host ``ServingEngine`` and ``GraphServingEngine`` (one and
             two groups) on the card equal the port's CPU run in every
             output, tokens included; the device engine's interval program
             replays once an interval, its reconfiguration program once a
             reconfiguration, and the greedy launches once per
             reconfiguration (+1 in the warm-up before that program's
             capture); (b) qwen3-8b at full width (bf16) cut to 8 of 36
             layers (SERVE_LAYERS) behind both engines: 4 streams, 16
             slots, 512 positions, pages of 16 tokens, 256 pages, a
             reconfiguration every 32 steps, 32 requests (stream 0 a
             shared 48-token prefix): the host engine once, the device
             engine cold (with its captures) and warm, schedules equal to
             the host engine's (slot shares within 1e-6: float32 against
             float64), tokens equal under the token rule
             (``tests/_torch_serving_ref.py``: a request may part from the
             host engine's tokens only at a step where the host's top-2
             logit gap is at most 1e-5 + 1e-4 |top|), every
             partition summing to 256 above its floor; walls, tokens/s,
             ms a step, capture seconds, the card's busy share over one
             profiled warm interval, peak memory and the idle tail steps;
             (c) the device engine with CBP off at full width:
             no reconfiguration, no greedy launch.
16. train  — the training stack (``repro_torch.train``, ``optim``,
             ``data``, ``launch.train``, ``checkpoint``), which calls no
             hand-written kernel (the reference's train step reaches
             none): (a) every smoke config, 3 AdamW steps from parameters
             built on the CPU and copied to the card (float32, TF32 off),
             losses and parameters against the port's CPU run (the
             bound at TRAIN_ATOL); (b) ``train_loop`` on the card: the
             qwen3-8b smoke loss falls over 30 steps, a mamba2-1.3b
             restart re-runs only the 6 missing steps, and a bf16 qwen3-8b
             smoke model's parameters and f32 optimizer state come back
             from a checkpoint bit for bit; (c) qwen3-8b at full width
             (bf16, remat "full") cut to 8 of 36 layers: 6 AdamW steps and
             3 Adafactor steps on 4 x 1,024 tokens through
             ``build_train_step`` and the ``PrefetchPipeline``: finite
             losses, warm step time, tokens/s, 6 N T over the step at 989
             TFLOP/s (and with the remat recompute), the optimizer's time
             alone, the card's busy share and device time by kernel kind
             over one profiled step, the run's peak memory (above what
             earlier phases left allocated) within PERF.md's prediction
             (TRAIN_PEAK_LIMIT), and two steps with per-layer
             selects in place of one ``unbind`` (no checkpoint is written
             at this size: 39 GB); (d) ``tests/test_train_loop.py:34``'s
             plant through the port's ``CBPCoordinator`` on the card, its
             assertions unchanged, one greedy launch per reconfiguration.
             The launch counts stay 0 over (a)-(c).
17. shard  — the sweep's (manager, mix) grid and the static search's
             workloads sharded over ``repro_torch.distributed.use_devices(
             [cuda:0] * N)`` (the split runs block by block on the one
             card): the 4096-mix sweep and ``fig5_potential``'s 640
             workloads on 2 shards, the 32-mix sweep and one
             ``run_timeline`` (CBP over the 32 mixes, 20 ms) on 3, each
             against its unsharded run on the card: discrete outputs
             (units, prefetch, active, top-k indices) exactly equal, floats
             within rtol 1e-12; walls, the shard grid, the largest
             differences and the greedy's launches (``launches_shard``).
             Then ``GraphServingEngine``'s groups sharded over forced
             blocks, each block with its own KV cache and CUDA graphs:
             (e) the reference's sharded-engine fixture
             (``tests/test_serving_jax.py``'s ``_PARITY_SCRIPT``) with the
             qwen3-8b smoke model, 8 groups on 8 blocks and 16 on 4 (also
             on a forced (4, 4, 2, 2) grid, whose blocks hold groups that
             are not contiguous), each against the unsharded card run and
             the port's CPU sharded run; (f) phase 15(b)'s model
             (qwen3-8b, 8 of 36 layers) at its engine configuration, 2
             groups on 2 blocks against the unsharded 2-group engine, 16
             requests.  Tokens equal under the token rule, every other
             discrete output exactly, slot shares and queue waits within
             1e-6; one interval replay a block an interval, one
             reconfiguration replay and one greedy launch a
             reconfiguration a block runs
             (+1 a block in the warm-up before its capture); the largest
             logit difference between one decode of the whole batch and
             the same rows in the blocks' batches; for (f) the plan, ms a
             step (host wall less capture seconds), tokens/s, capture
             seconds per block and peak memory (below the unsharded peak
             plus half the weights: the blocks share the model's).  Its
             greedy launches count in ``launches_shard``.
18. mesh   — the training mesh (``repro_torch.distributed``'s mesh state,
             ``launch/shardings.py``, ``launch/mesh_train.py``) on a (1, 1)
             ("data", "model") NCCL mesh of this process, one card being
             one rank: (a) the reference's sharded-training gate
             (``tests/test_distributed.py``: qwen3-8b, qwen3-moe-30b-a3b
             and mamba2-1.3b smoke configs in f32 with sequence-sharded
             activations and full remat, three AdamW steps at lr 1e-3 in
             2 microbatches), parameters placed by ``param_specs`` and the
             optimizer state by ``opt_state_specs``, against the same
             steps without a mesh on the card: losses finite and falling,
             losses and parameters bit for bit or else within phase
             16(a)'s bound, the largest differences printed; (b) qwen3-8b
             at full width cut to 8 layers, two AdamW steps of 4 x 1,024
             tokens with and without the mesh, one run after the other,
             held as in (a): warm step times (the cost of DTensor
             dispatch), peak memory beside ``analytic_memory``'s
             prediction for one card; (c) ``analytic_memory`` for the full
             36-layer config with AdamW on 1 card and on a (2, 2) mesh of
             4.  The process group ends with the phase.  The mesh path
             launches none of the five kernels (``launches_mesh``).
19. pipe   — the GPipe pipeline (``repro_torch.train.pipeline``) on a
             (1, 1) ("pod", "data") NCCL mesh of this process, one card
             being one rank and one stage: (a) the CPU tests' gate cases
             at S = 1 (the reference gate's tanh stack, D = 16, L 4 and
             8, 1-4 microbatches of 8 rows, f32): outputs and gradients
             of ``sum(out ** 2)`` bit for bit the port's sequential stack
             on the card, within 1e-5 and PR 25's gradient bound of it on
             the CPU; (b) qwen3-8b at full width cut to 8 of 36 layers
             (bf16, full remat), 4 microbatches of 1 x 1,024 tokens: the
             loss through the pipeline against ``transformer.forward`` a
             microbatch at a time (``microbatch_loss``), loss and every
             layer gradient bit for bit; first-call and warm forward +
             backward times of both, in turns, and their peak memory.
             The pipeline launches none of the five kernels
             (``launches_pipe``).
20. dry    — the dry run (``repro_torch.launch.dryrun``,
             ``launch/op_costs.py``) in two subprocesses of its own (a
             fake process group is process state; ``python3
             chip_smoke.py --dry-worker step|cell OUT``, each bounded by
             DRY_TIMEOUT; ``cell``, which needs no card, starts after
             the build and runs beside phases 2-19): (a) phase
             16(c)'s cell (qwen3-8b cut to 8 of 36 layers, 4 x 1,024
             tokens, AdamW) counted on ``meta`` tensors as rank 0 of a
             fake (1, 1) group with a card mesh, then the same step run
             for real on the card: the counted FLOPs equal
             ``FlopCounterMode``'s count of the real step exactly, the
             peak estimate is within DRY_PEAK_RTOL of its
             ``max_memory_allocated``, the step-time bound printed beside
             the warm step; (b) qwen3-8b ``train_4k`` on the single pod,
             a fake group of 256 ranks with a card mesh: status ``ok``,
             its counts, dominant term, trace seconds and per-device peak
             beside ``analytic_memory``; (c) the cells PyTorch 2.11 failed
             before the mesh faults' repairs (zamba2-7b ``train_4k`` and
             ``prefill_32k``, grok-1-314b ``decode_32k`` and two-pod
             ``train_4k``), cut to a layer or two: status ``ok``; (d)
             the Fig. 5 seeded climb (``repro_torch.launch.hillclimb``,
             4 workloads, 4 seeds) on the card, held to the CPU's climb
             (run in the ``cell`` worker): allocations equal or tied,
             weighted speedups within rtol 1e-9.  The dry run launches
             none of the five kernels (``launches_dry``).

After every phase a ``memory`` line gives the device memory still
allocated and what a collector pass then frees (memory that reference
cycles held), with the port's classes among what it found; after phase
15 a ``drop`` line gives the memory allocated with the collector off
before and after dropping the engines, then the model.

Its second path is the paper's kernel-level binding: the UCP block
planner (``repro_torch.runtime.cbp_runtime.plan_kernel_blocks``) splits an
on-chip memory budget among a kernel's tiles, and the four kernels run
under the planned knobs:

5. plan    — the planner on the card for the four specs of the committed
             ``results/bench/kernel_blocks.json`` record (its knobs must
             equal the record's) and for full-width specs at a budget of
             the card's shared memory per block; every plan must equal the
             port's CPU run, with one greedy launch per capacity group;
             and ``benchmarks/runtime_bench.py``'s five planner shapes in
             one greedy launch, equal to the scalar numpy planner and to
             the committed ``results/bench/runtime_bench.json``.
6. kernels — the path itself, driven once at full width (qwen3-8b FFN
             matmul, prefill attention and decode; mamba2-1.3b SSD scan)
             with the launch counts reset just before it; then each of
             ``cbp_matmul``, ``flash_attention``, ``flash_decode`` and
             ``ssd_scan`` against its plain PyTorch version on the card
             under (a) the planned knobs and (b) its signature defaults,
             at the record's shapes (also against a CPU run of the plain
             version) and at full width, planned against default knobs,
             within the limits of ``repro_torch.kernels.tolerance``; and
             times of kernel, plain version and the PyTorch library call
             beside each kernel's bound.  ``cbp_matmul`` and
             ``flash_attention`` also run in float32 at full width
             (3xTF32 on the tensor cores), held to their plain versions
             at the f32 tolerance and timed beside ``torch.matmul`` and
             ``scaled_dot_product_attention`` in float32 with TF32 off;
             ``ssd_scan`` also runs in bfloat16 (mamba2's parameter
             dtype) at full width, against its plain version.
             Edge cases (ragged matmul dims, m < 8, cur_len 0, Sq != Sk,
             not causal, odd head dims, unaligned bases) are the card
             tests' (``pytest -m cuda``).

Every phase prints one JSON line with the card's name and power limit,
and a last ``done`` line gives the script's seconds; then comes the
``kernels`` line (every kernel's launches on its path, error, times and
bound; the greedy's at the bucketed sweep's own boundary inputs, with its
launches on every path, 0 in phase 14, phase 15's as ``launches_serve``,
phase 16(d)'s as ``launches_train_binding``, and the shapes of every
path's inputs it was held to; every kernel's ``launches_train``, its
launches over phase 16(a)-(c), ``launches_shard``, over phase 17, and
``launches_mesh``, over phase 18(a)-(b), ``launches_pipe``, over
phase 19(a)-(b), and ``launches_dry``, over phase 20).
Any failed check exits non-zero before the last line, which is ``{"ok":
true, "device": {...}}`` on success.
Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Geomean weighted speedups of ``run_sweep(random_mixes(32, 16, seed=1),
#: total_ms=100.0)`` from the JAX reference package run in float64 on the
#: CPU (CBP's 1.4995 is also the committed results/bench/sweep_smoke.json).
EXPECTED_GEOMEANS = {
    "baseline": 1.0, "equal off": 1.1747, "equal on": 1.2955,
    "only cache": 1.2164, "only bw": 1.1065, "only pref": 1.1054,
    "bw+pref": 1.2334, "bw+cache": 1.3254, "cache+pref": 1.361,
    "CPpf": 1.3984, "CBP": 1.4995, "auction": 1.2679, "qos": 1.3012,
    "bank bw": 1.1172,
}

#: Weighted speedups of ``repro.sim.run_all_managers(apps, total_ms=100.0)``
#: from the JAX reference package (its scalar path) in float64 on the CPU:
#: w1, and the Fig. 1 pair lbm + xalancbmk at 64 units and 16 GB/s.
EXPECTED_MANAGER_WS = {
    "w1": {
        "baseline": 1.0, "equal off": 1.2686207747,
        "equal on": 1.44107048851, "only cache": 1.27680497982,
        "only bw": 1.14646371984, "only pref": 1.17718867294,
        "bw+pref": 1.36031508075, "bw+cache": 1.43256562304,
        "cache+pref": 1.51276292988, "CPpf": 1.57323879932,
        "CBP": 1.72709607072, "auction": 1.40497973629,
        "qos": 1.41150245935, "bank bw": 1.18437732246},
    "fig1": {
        "baseline": 1.0, "equal off": 1.38639009706,
        "equal on": 1.59299776874, "only cache": 1.6142227081,
        "only bw": 1.15319336117, "only pref": 1.21637117807,
        "bw+pref": 1.38143532716, "bw+cache": 1.831339208,
        "cache+pref": 1.77907434008, "CPpf": 1.77792748354,
        "CBP": 2.127461531, "auction": 1.78992738353,
        "qos": 1.81588903673, "bank bw": 1.27809563945},
}

#: Figs. 2-4 of ``repro.sim.characterization`` (numpy): the paper's Fig. 2
#: class counts, named values, and the sum of the whole sensitivity table.
EXPECTED_CLASS_COUNTS = {
    "CS-BS-PS": 6, "CS-BS": 8, "BS-PS": 6, "CS": 3, "BS": 3, "I": 3}
EXPECTED_CHARACTERIZATION = {
    "xalancbmk P-B": -0.0822767713258,
    "hmmer P-L": 0.132251325322, "hmmer P-B": 0.0893947314368,
    "gcc P-L": 0.00225704640665, "gcc P-H": 0.219894091663,
    "fig4d gain": [1.09469437917, 0.988273816569, 0.753789396226,
                   0.629445014925, 0.576064409372],
    "fig4a on": [0.189565685978, 0.379131371956, 0.565479966002,
                 0.670613710398, 0.717262870986],
    "table sum": 25.8806139510873,
}

#: Phases 3-4 as last measured before the length buckets (PERF.md §5; H100
#: 80GB HBM3, 700 W): warm walls and greedy launches.
BEFORE_BUCKETS = {"sweep_wall_s": 1.444, "scale_wall_s": 2.193,
                  "launches": 10}

# H100 SXM peaks from NVIDIA's data sheet, at the full 700 W limit: HBM3
# bandwidth, and the FP64 rate outside the tensor cores (the greedy's
# divisions and subtractions are plain f64 instructions).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

#: Dense peak rates of the same data sheet for the kernel-level path: bf16
#: and TF32 on the tensor cores, and float32 on the CUDA cores.  The
#: matmul's and attention's f32 products are three TF32 products each
#: (3xTF32), so their bound is three times their FLOP at the TF32 rate;
#: the SSD scan's f32 products are three bf16 products each (its inputs
#: split into bf16 hi + lo), so its bound is three times its FLOP at the
#: bf16 rate; decode's f32 work runs on the CUDA cores.
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12

#: The four specs of ``benchmarks/kernel_bench.py::kernel_block_plan_bench``
#: (f32) and the knobs its record planned for them
#: (results/bench/kernel_blocks.json); two budget tiers = 2 capacity groups.
RECORD_SPECS = [
    {"kernel": "cbp_matmul", "m": 512, "n": 512, "k": 512,
     "dtype_bytes": 4, "budget_bytes": 768 * 1024},
    {"kernel": "flash_attention", "seq_q": 512, "seq_kv": 512,
     "head_dim": 64, "dtype_bytes": 4, "budget_bytes": 768 * 1024},
    {"kernel": "flash_decode", "seq_kv": 2048, "head_dim": 64,
     "dtype_bytes": 4, "budget_bytes": 384 * 1024},
    {"kernel": "ssd_scan", "seq_len": 512, "state_dim": 32,
     "dtype_bytes": 4, "budget_bytes": 384 * 1024},
]
EXPECTED_RECORD_KNOBS = [
    {"block_m": 256, "block_n": 256, "block_k": 256},
    {"block_q": 256, "block_kv": 256},
    {"block_kv": 128},
    {"chunk": 128},
]
RECORD_GROUPS = 2
#: Full-width shapes of models the repo configures: qwen3-8b's FFN up
#: projection, prefill (k/v repeated to 32 heads, as repeat_kv does) and
#: decode at batch 8 (bf16); mamba2-1.3b's SSD scan (f32).
FULL_SPECS = [
    {"kernel": "cbp_matmul", "m": 4096, "n": 12288, "k": 4096,
     "dtype_bytes": 2},
    {"kernel": "flash_attention", "seq_q": 4096, "seq_kv": 4096,
     "head_dim": 128, "dtype_bytes": 2},
    {"kernel": "flash_decode", "seq_kv": 8192, "head_dim": 128,
     "dtype_bytes": 2},
    {"kernel": "ssd_scan", "seq_len": 4096, "state_dim": 128,
     "dtype_bytes": 4},
]
DECODE_LENS = (8192, 5000)
#: file:line of each Pallas kernel's pallas_call wrapper.
REPLACES = {
    "cbp_matmul": "src/repro/kernels/cbp_matmul/kernel.py:45",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:86",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:65",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:72",
}

#: ``benchmarks/runtime_bench.py``'s planner shapes (``PLAN_SHAPES``, bf16
#: at the reference's default budget), planned in one batched call.
RUNTIME_PLAN_SHAPES = ((512, 512, 512), (1024, 1024, 1024), (384, 768, 96),
                       (97, 53, 160), (6, 4, 512))
RUNTIME_RECORD = ROOT / "results" / "bench" / "runtime_bench.json"

#: The reference's training-plant trajectories (``tools/plant_golden.py``:
#: ``repro.runtime.plant_jax.host_reference_run``), floats as float.hex.
PLANT_GOLDEN = ROOT / "tests" / "data" / "plant_golden.json"
PLANT_FIELDS = ("kinds", "t_ms", "duration_ms", "cache_units", "bandwidth",
                "prefetch_on", "ipc", "queuing_delay_ns")
PLANT_FLOATS = ("t_ms", "duration_ms", "bandwidth", "ipc",
                "queuing_delay_ns")
#: The port's host golden (``host_reference_run``) sums Algorithm 1's
#: delays with ``torch.sum``, not in numpy's order: its floats are held to
#: the controllers' float64 tolerance of the reference's.
PLANT_HOST_RTOL = 1e-12
PLANT_WARM_RUNS = 10

#: Phase 12: the reference's numpy golden of the static search, the
#: reference's tolerances for its device backend against it (top-k
#: weighted speedups, tests/test_static_search.py:64; the Pareto case's
#: weighted speedups and fairness, l.383-389), and the committed
#: results/bench/fig5_smoke.json record's geo_all3.
STATIC_GOLDEN = ROOT / "tests" / "data" / "static_search_golden.json"
STATIC_WS_RTOL = 1e-5
STATIC_PARETO_RTOL = 1e-12
FIG5_GEO_ALL3 = 1.269

#: Phase 13: the reference's float64 stream aggregates, the port's
#: sweep tolerance for them, the committed results/bench/stream_bench.json
#: record's CBP geomean, the bound on the full head's peak memory against
#: its 1-chunk prefix, and stream_bench.py::resume_parity_gate's plan.
STREAM_GOLDEN = ROOT / "tests" / "data" / "stream_golden.json"
STREAM_RTOL = 1e-9
STREAM_CBP_RECORD = 1.401397
STREAM_PEAK_RATIO = 1.10
STREAM_PARITY_PLAN = [{"kind": "dispatch_error", "chunk": 0, "count": 1},
                      {"kind": "nan_poison", "chunk": 1},
                      {"kind": "kill", "chunk": 2}]

N_APPS, TOTAL_UNITS, MIN_WAYS = 16, 256, 4
SMALL_MIXES, SCALE_MIXES, TOTAL_MS, SEED = 32, 4096, 100.0, 1
RTOL = 1e-9


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(card: str, **fields) -> None:
    print(json.dumps({**fields, "card": card}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# phase 2: the Lookahead greedy kernel against its plain version
# --------------------------------------------------------------------- #

def greedy_inputs(B: int, masked: bool, seed: int):
    """Concave, nonmonotone and flat curve thirds; masked rows get a random
    active set (with some all-inactive rows) and the capacity left after
    pinning the inactive clients, as CPpf passes it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, U = N_APPS, TOTAL_UNITS
    u = np.arange(U + 1, dtype=np.float64)
    third = B // 3
    curves = np.concatenate([
        rng.uniform(0.0, 50.0, (third, n, 1))
        * (1.0 - np.exp(-u / rng.uniform(2.0, 40.0, (third, n, 1)))),
        np.cumsum(rng.normal(0.0, 1.0, (third, n, U + 1)), axis=-1),
        np.zeros((B - 2 * third, n, U + 1)),
    ])
    mins = np.full(B, MIN_WAYS, dtype=np.int32)
    if masked:
        active = rng.integers(0, 2, (B, n)).astype(np.int32)
        active[::17] = 0
    else:
        active = np.ones((B, n), dtype=np.int32)
    remaining = (U - mins * (n - active.sum(axis=1))).astype(np.int32)
    dev = "cuda"
    return (torch.as_tensor(curves, device=dev),
            torch.as_tensor(mins, device=dev),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(remaining, device=dev))


@contextlib.contextmanager
def one_table():
    """Stack every manager of a sweep into one table (the reference the
    length buckets are held to) by making the bucket rule return one
    group."""
    from repro_torch.sim import timeline

    real = timeline._length_buckets
    timeline._length_buckets = lambda lens: [list(range(len(lens)))]
    try:
        yield
    finally:
        timeline._length_buckets = real


def first_greedy_inputs(run):
    """The greedy's inputs at the first call ``run()`` makes to it: every
    path reaches the kernel's wrapper through ``core.cache_controller``,
    where a stand-in keeps a copy of the first call's arguments and stops
    the run.  Returns ``((curves, min_units, active, remaining),
    total_units)``."""
    from repro_torch.core import cache_controller

    class Captured(Exception):
        pass

    got = {}

    def capture(*args, total_units):
        got["args"] = tuple(t.clone() for t in args)
        got["U"] = total_units
        raise Captured

    real = cache_controller.lookahead_greedy
    cache_controller.lookahead_greedy = capture
    try:
        run()
    except Captured:
        pass
    finally:
        cache_controller.lookahead_greedy = real
    check("args" in got, "a path never called the greedy")
    return got["args"], got["U"]


def path_captures():
    """{case: runner} for every path whose greedy inputs the kernel is
    held to: the 4096-mix sweep in buckets (the main path) and as one
    table (all five Lookahead managers in one launch, B = 20,480), the
    segment backend, each Fig. 12 grid (the 512-unit one included), the
    scalar plant on w1 and on the Fig. 1 pair (64 units; CPpf's masked
    call too), the training plant (B = 1, n = 12, U = 96) and the
    streaming sweep's first chunk (B = 512)."""
    from repro_torch.core.types import CBPParams
    from repro_torch.sim import (WORKLOADS, CMPConfig, random_mixes,
                                 run_all_managers, run_sweep)

    mixes = random_mixes(SCALE_MIXES, N_APPS, seed=SEED)

    def sweep(**kw):
        return lambda: run_sweep(mixes, total_ms=TOTAL_MS, **kw)

    def flat():
        with one_table():
            run_sweep(mixes, total_ms=TOTAL_MS)

    fig1 = CMPConfig(total_cache_units=64, total_bandwidth=16.0)
    cases = {
        "sweep_buckets": sweep(),
        "sweep_one_table": flat,
        "segment": sweep(config=CMPConfig(timeline_backend="segment")),
    }
    for family, (cfg, grid) in fig12_grids().items():
        cases[f"grid_{family}"] = sweep(
            managers=["CBP"], config=CMPConfig(**cfg),
            param_grid=[CBPParams(**f) for f in grid])
    cases.update({
        "managers_w1": lambda: run_all_managers(
            WORKLOADS["w1"], total_ms=TOTAL_MS),
        "managers_fig1": lambda: run_all_managers(
            ["lbm", "xalancbmk"], total_ms=TOTAL_MS, config=fig1),
        "managers_fig1_cppf": lambda: run_all_managers(
            ["lbm", "xalancbmk"], total_ms=TOTAL_MS, names=["CPpf"],
            config=fig1),
        "training_plant": training_plant_run,
        "stream": stream_head_step,
        "serve": serve_first_boundary,
    })
    return cases


def stream_head_step():
    """Chunk 0 of phase 13's full head through the stream's own per-chunk
    step (``_StreamRunner.dispatch``, which ``_dispatch_and_fetch`` calls
    inside its retry barrier), on the runner's CUDA stream: it reaches the
    greedy at the first CBP boundary with B = 512, n = 16, U = 256."""
    import torch
    from repro_torch.sim.stream_sweep import _StreamRunner

    args = json.loads(STREAM_GOLDEN.read_text())["cases"]["full_head"][
        "config"]
    runner = _StreamRunner(stream_config(args), None, False, time.sleep,
                           torch.device("cuda"))
    try:
        with runner.on_device():
            runner.dispatch(runner._generate(0))
    finally:
        torch.cuda.synchronize()


def training_plant_run():
    """The training plant's fused schedule at ``runtime_bench``'s full
    shape, on a new model (a new graph key): its warm-up reaches the greedy
    at the first boundary with B = 1, n = 12, U = 96."""
    from repro_torch.runtime.plant import run_fused_schedule
    from repro_torch.train.plant_model import make_stream_plant_model

    args, _ = load_plant_golden()["full"]
    _step_fn, step_model = make_stream_plant_model(
        args["n_clients"], args["total_units"], args["total_bandwidth"],
        seed=args["seed"], device="cuda")
    run_fused_schedule(step_model, **plant_kwargs(args))


def greedy_bound(args, U: int):
    """(bytes, operations) the greedy needs on these inputs: every input
    read once and the outputs written once; one f64 subtraction and one
    division for each candidate step of a live row's first trip, which
    any exact greedy must evaluate (later trips need fewer, and how many
    depends on the algorithm)."""
    import torch

    curves, mins, active, rem = args
    B, n, _ = curves.shape
    n_bytes = (curves.numel() * 8
               + 4 * (mins.numel() + rem.numel() + active.numel()
                      + B * n + B))
    balance = U - n * mins.long()
    cap = torch.minimum(balance, torch.clamp(rem.long(), max=U) - mins)
    cap = torch.where((active != 0) & (balance > 0)[:, None],
                      cap.clamp(min=0)[:, None], 0)
    return n_bytes, 2 * int(cap.sum())


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(card: str, shapes) -> dict:
    """Compare and time the kernel at each batch size in ``shapes`` and on
    the inputs of each path's first greedy call (:func:`path_captures`);
    returns the measurements per (B, masked) and per path."""
    import torch
    from repro_torch.kernels.lookahead_greedy import (
        LAUNCHES,
        lookahead_greedy,
        lookahead_greedy_plain,
    )

    out = {}

    def cases():
        for B in shapes:
            for masked in (False, True):
                yield ((B, masked), greedy_inputs(B, masked, seed=B + masked),
                       TOTAL_UNITS)
        for key, run in path_captures().items():
            yield (key, *first_greedy_inputs(run))

    for key, args, U in cases():
        B, n = args[0].shape[:2]
        masked = key[1] if isinstance(key, tuple) else bool(
            (args[2] == 0).any())
        launches0 = LAUNCHES.count
        alloc, bal = lookahead_greedy(*args, total_units=U)
        torch.cuda.synchronize()
        work, plain = {}, []
        plain_ms = cuda_ms(lambda: plain.append(lookahead_greedy_plain(
            *args, total_units=U, work=work)), 1)
        alloc_p, bal_p = plain[0]
        err = max(int((alloc - alloc_p).abs().max()),
                  int((bal - bal_p).abs().max()))
        check(torch.equal(alloc, alloc_p) and torch.equal(bal, bal_p),
              f"lookahead_greedy != plain at {key} (B={B}, n={n}, U={U}): "
              f"{int((alloc != alloc_p).any(1).sum())} rows differ")
        lookahead_greedy(*args, total_units=U)          # warm-up
        ms = cuda_ms(lambda: lookahead_greedy(*args, total_units=U), 20)
        n_bytes, n_ops = greedy_bound(args, U)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP64_OPS_PER_S * 1e3
        rec = {"inputs": "synthetic" if isinstance(key, tuple) else key,
               "B": B, "masked": masked, "n": n, "U": U,
               "launches": LAUNCHES.count - launches0,
               "exact": True, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "trips": work["trips"],
               "plain_candidates": work["candidates"],
               "bytes": n_bytes, "operations": n_ops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None,
               "library_note": "no single PyTorch call computes the "
                               "Lookahead greedy"}
        emit(card, phase="kernel", name="lookahead_greedy", **rec)
        out[key] = rec
        del alloc, bal, alloc_p, bal_p, args
    return out


# --------------------------------------------------------------------- #
# phases 3-4: the Table-3 sweep
# --------------------------------------------------------------------- #

def boundary_groups(total_ms: float) -> int:
    """The most Lookahead managers that reallocate at one boundary of the
    stacked table (the greedy's G: it launches on G * mixes rows)."""
    import numpy as np
    from repro_torch.core.types import CBPParams
    from repro_torch.sim import policies, timeline
    from repro_torch.sim.managers import MANAGER_NAMES
    from repro_torch.sim.sweep import BatchedCMPPlant, _manager_spec

    plant = BatchedCMPPlant([["mcf"] * N_APPS], device="cpu")
    specs = [_manager_spec(plant, name, total_ms, CBPParams())
             for name in MANAGER_NAMES]
    _kinds, _acc, reconf = timeline.stack_tables(
        [timeline.segment_table(s.schedule) for s in specs],
        [timeline.RUN if s.variant == "cppf" else None for s in specs])
    look = np.array([s.cache_dynamic
                     and s.cache_policy == policies.CACHE_LOOKAHEAD
                     for s in specs])
    return int((reconf & look[:, None]).sum(axis=0).max())


def compare_sweeps(a, b, exact_floats: bool, what: str) -> float:
    """Discrete outputs equal; floats bitwise or within RTOL.  Returns the
    largest relative float difference."""
    import numpy as np

    worst = 0.0
    pairs = [("baseline", a.baseline_ipc, b.baseline_ipc)]
    for name in a.manager_names:
        fa, fb = a.final_alloc[name], b.final_alloc[name]
        check(np.array_equal(fa.cache_units, fb.cache_units),
              f"{what}: cache_units differ for {name}")
        check(np.array_equal(fa.prefetch_on, fb.prefetch_on),
              f"{what}: prefetch_on differs for {name}")
        pairs += [(f"{name} ipc", a.ipc[name], b.ipc[name]),
                  (f"{name} bandwidth", fa.bandwidth, fb.bandwidth)]
    for label, x, y in pairs:
        check(x.shape == y.shape and np.isfinite(x).all(),
              f"{what}: {label} has shape {x.shape} or non-finite values")
        if exact_floats:
            check(np.array_equal(x, y), f"{what}: {label} not bitwise equal")
        else:
            check(np.allclose(x, y, rtol=RTOL, atol=0.0),
                  f"{what}: {label} beyond rtol {RTOL}")
        worst = max(worst, float(np.max(np.abs(x - y) / np.abs(y))))
    return worst


def timed_sweep(mixes, **kw):
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.sim import run_sweep

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_sweep(mixes, total_ms=TOTAL_MS, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, launch_counts()


def device_profile(fn, kernel: str = "", categories=None) -> dict:
    """Run ``fn`` once under the profiler: the device time of every CUDA
    kernel (and copy) it ran, summed once each, the part of kernels whose
    name holds ``kernel``, and the kernels that took the most.  Kernel
    durations are device-side, so they hold for an unprofiled run; the
    profiled wall does not (tracing slows the host).  Values are None
    where the profiler saw no device events.  ``categories`` ({category:
    name substrings}, tried in order; the rest is "other") adds the
    device time by category.  Only the device is traced, and its events
    are read as the tracer gives them: nothing here reads host-side
    operator events, and building their event tree takes the host about
    a minute for a sweep."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    by_name = collections.Counter()
    by_category = collections.Counter()
    for e in dev:
        seconds = e.duration_ns() / 1e9
        name = e.name()
        by_name[name[:80]] += seconds
        if categories:
            by_category[next((c for c, keys in categories.items()
                              if any(k in name for k in keys)),
                             "other")] += seconds
    device_s = sum(by_name.values())
    part_s = sum(v for k, v in by_name.items() if kernel and kernel in k)
    rec = {"profiled_wall_s": wall,
           "device_events": len(dev),
           "device_s": device_s if dev else None,
           "part_device_s": part_s if dev else None,
           "top_device_s": [[k, v] for k, v in by_name.most_common(5)]}
    if categories:
        rec["category_device_s"] = dict(by_category)
    return rec


def profile_sweep(mixes) -> dict:
    """One extra, profiled sweep (:func:`device_profile`), the greedy
    kernel's part apart."""
    from repro_torch.sim import run_sweep

    rec = device_profile(lambda: run_sweep(mixes, total_ms=TOTAL_MS),
                         "lookahead_greedy")
    rec["greedy_device_s"] = rec.pop("part_device_s")
    return rec


def bucket_comparison(mixes, bucketed, counts):
    """Time the same sweep as one stacked table (:func:`one_table`) and
    hold the bucketed run to it bit for bit; returns the one table's (warm
    wall, greedy launches)."""
    with one_table():
        timed_sweep(mixes)                                    # warm-up
        flat, flat_s, flat_counts = timed_sweep(mixes)
    compare_sweeps(bucketed, flat, exact_floats=True,
                   what="length buckets vs one table")
    check(flat_counts["lookahead_greedy"] > 0
          and counts["lookahead_greedy"] > 0,
          "a sweep did not launch the lookahead_greedy kernel")
    return flat_s, flat_counts["lookahead_greedy"]


def sweep_phase(card: str):
    import numpy as np
    from repro_torch.sim import CMPConfig, random_mixes, run_sweep

    mixes = random_mixes(SMALL_MIXES, N_APPS, seed=SEED)
    t0 = time.perf_counter()
    cpu = run_sweep(mixes, total_ms=TOTAL_MS, device="cpu")
    cpu_s = time.perf_counter() - t0
    _cold, cold_s, _ = timed_sweep(mixes)
    gpu, warm_s, counts = timed_sweep(mixes)
    check(counts["lookahead_greedy"] > 0,
          "the sweep did not launch the lookahead_greedy kernel")
    got = gpu.summary()
    for name, want in EXPECTED_GEOMEANS.items():
        check(got[name] == want,
              f"geomean WS of {name}: {got[name]} != reference {want}")
    worst = compare_sweeps(gpu, cpu, exact_floats=False,
                           what="GPU vs CPU sweep")
    fused, fused_s, _ = timed_sweep(
        mixes, config=CMPConfig(timeline_backend="fused"))
    compare_sweeps(gpu, fused, exact_floats=True,
                   what="stacked vs fused on the GPU")
    flat_s, flat_launches = bucket_comparison(mixes, gpu, counts)
    prof = profile_sweep(mixes)
    emit(card, phase="sweep", mixes=SMALL_MIXES, managers=len(got),
         total_ms=TOTAL_MS, warm_wall_s=warm_s, cold_wall_s=cold_s,
         fused_wall_s=fused_s, cpu_port_wall_s=cpu_s,
         launches=counts, geomeans=got,
         max_rel_diff_vs_cpu=worst, stacked_equals_fused=True,
         length_buckets={"bucketed_wall_s": warm_s,
                         "bucketed_launches": counts["lookahead_greedy"],
                         "one_table_wall_s": flat_s,
                         "one_table_launches": flat_launches,
                         "bit_identical": True,
                         "before_buckets_wall_s":
                         BEFORE_BUCKETS["sweep_wall_s"],
                         "before_buckets_launches":
                         BEFORE_BUCKETS["launches"]},
         device_busy_share=(prof["device_s"] / warm_s
                            if prof["device_s"] is not None else None),
         profile=prof)
    return gpu, counts, flat_launches


def scale_phase(card: str, small):
    import torch
    from repro_torch.sim import random_mixes

    mixes = random_mixes(SCALE_MIXES, N_APPS, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    _cold, cold_s, _ = timed_sweep(mixes)
    res, warm_s, counts = timed_sweep(mixes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts["lookahead_greedy"] > 0,
          "the scale sweep did not launch the lookahead_greedy kernel")
    # random_mixes draws mix by mix: the first 32 of 4096 are phase 3's.
    for name in res.manager_names:
        check(res.ipc[name].shape == (SCALE_MIXES, N_APPS),
              f"scale sweep: {name} ipc shape {res.ipc[name].shape}")
    worst = compare_sweeps(head(res, SMALL_MIXES), small, exact_floats=False,
                           what="scale sweep's first 32 mixes vs phase 3")
    torch.cuda.reset_peak_memory_stats()
    flat_s, flat_launches = bucket_comparison(mixes, res, counts)
    flat_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof = profile_sweep(mixes)
    greedy_s = prof["greedy_device_s"]
    emit(card, phase="scale", mixes=SCALE_MIXES, managers=len(res.ipc),
         rows=len(res.ipc) * SCALE_MIXES, total_ms=TOTAL_MS,
         warm_wall_s=warm_s, cold_wall_s=cold_s,
         mixes_per_s=SCALE_MIXES / warm_s, launches=counts,
         peak_device_gb=peak_gb,
         length_buckets={"bucketed_wall_s": warm_s,
                         "bucketed_launches": counts["lookahead_greedy"],
                         "one_table_wall_s": flat_s,
                         "one_table_launches": flat_launches,
                         "one_table_peak_device_gb": flat_peak_gb,
                         "bit_identical": True,
                         "before_buckets_wall_s":
                         BEFORE_BUCKETS["scale_wall_s"],
                         "before_buckets_launches":
                         BEFORE_BUCKETS["launches"]},
         kernel_share_of_warm_wall=(greedy_s / warm_s
                                    if greedy_s is not None else None),
         greedy_ms_per_launch=(greedy_s * 1e3 / counts["lookahead_greedy"]
                               if greedy_s is not None else None),
         device_busy_share=(prof["device_s"] / warm_s
                            if prof["device_s"] is not None else None),
         profile=prof, geomeans=res.summary(),
         max_rel_diff_head_vs_phase3=worst)
    return res, counts, flat_launches


def head(res, m: int):
    """The first ``m`` mixes of a sweep result (a leading params axis, if
    any, kept)."""
    cut = (lambda a: a[..., :m, :])
    return type(res)(
        manager_names=res.manager_names, mixes=res.mixes[:m],
        ipc={k: cut(v) for k, v in res.ipc.items()},
        final_alloc={k: type(a)(
            cache_units=cut(a.cache_units), bandwidth=cut(a.bandwidth),
            prefetch_on=cut(a.prefetch_on))
            for k, a in res.final_alloc.items()},
        baseline_ipc=res.baseline_ipc[:m])


# --------------------------------------------------------------------- #
# phases 7-10: the host-coordinated paths
# --------------------------------------------------------------------- #

def segment_phase(card: str, stacked):
    """All 14 managers over the 4096 mixes on the segment backend (one
    model evaluation per Fig. 8 segment, the controllers between them),
    held to phase 4's stacked run by the reference's contract."""
    import numpy as np
    from repro_torch.sim import CMPConfig, random_mixes

    mixes = random_mixes(SCALE_MIXES, N_APPS, seed=SEED)
    seg, wall_s, counts = timed_sweep(
        mixes, config=CMPConfig(timeline_backend="segment"))
    check(counts["lookahead_greedy"] > 0,
          "the segment backend did not launch the lookahead_greedy kernel")
    worst_ipc = worst_bw = 0.0
    for name in stacked.manager_names:
        a, b = seg.final_alloc[name], stacked.final_alloc[name]
        check(np.array_equal(a.cache_units, b.cache_units),
              f"segment vs stacked: cache_units differ for {name}")
        check(np.array_equal(a.prefetch_on, b.prefetch_on),
              f"segment vs stacked: prefetch_on differs for {name}")
        check(np.isfinite(seg.ipc[name]).all(),
              f"segment: non-finite IPC for {name}")
        check(np.allclose(seg.ipc[name], stacked.ipc[name], rtol=RTOL,
                          atol=0.0),
              f"segment vs stacked: {name} IPC beyond rtol {RTOL}")
        check(np.allclose(a.bandwidth, b.bandwidth, rtol=1e-12, atol=0.0),
              f"segment vs stacked: {name} bandwidth beyond rtol 1e-12")
        worst_ipc = max(worst_ipc, float(np.max(
            np.abs(seg.ipc[name] - stacked.ipc[name])
            / np.abs(stacked.ipc[name]))))
        worst_bw = max(worst_bw, float(np.max(
            np.abs(a.bandwidth - b.bandwidth) / np.abs(b.bandwidth))))
    emit(card, phase="segment", mixes=SCALE_MIXES, managers=len(seg.ipc),
         total_ms=TOTAL_MS, wall_s=wall_s, launches=counts,
         max_rel_diff_ipc_vs_stacked=worst_ipc,
         max_rel_diff_bandwidth_vs_stacked=worst_bw,
         geomeans=seg.summary())
    return counts["lookahead_greedy"]


def fig12_grids():
    """Fig. 12's CBP grids (``benchmarks/paper_figs.py::fig12_sensitivity``):
    {family: (CMPConfig fields, [CBPParams fields])}."""
    ivals, mbs, sps = (1.0, 10.0, 100.0), (0.5, 1.0), (0.25, 0.5, 1.0)
    return {
        "reconfig_interval": ({}, [
            {"reconfiguration_interval_ms": ms, "prefetch_interval_ms": ms}
            for ms in ivals]),
        "min_bandwidth": ({}, [{"min_bandwidth_allocation": mb}
                               for mb in mbs]),
        "pf_sampling": ({}, [{"prefetch_sampling_period_ms": sp}
                             for sp in sps]),
        "cache_1MB_tile": ({"total_cache_units": 512,
                            "llc_extra_cycles": 4.0}, [{}]),
    }


def grid_phase(card: str):
    """Each Fig. 12 family as one ``run_sweep(param_grid=...)`` of CBP over
    the 4096 mixes: capacity invariants over every (param, mix), and the
    first 32 mixes of each slice against ``run_sweep(params=p)``."""
    import numpy as np
    import torch
    from repro_torch.core.types import CBPParams
    from repro_torch.sim import CMPConfig, random_mixes, run_sweep

    mixes = random_mixes(SCALE_MIXES, N_APPS, seed=SEED)
    launches = 0
    out = {}
    for family, (cfg_fields, grid_fields) in fig12_grids().items():
        cfg = CMPConfig(**cfg_fields)
        grid = [CBPParams(**f) for f in grid_fields]
        torch.cuda.reset_peak_memory_stats()
        res, wall_s, counts = timed_sweep(mixes, managers=["CBP"],
                                          config=cfg, param_grid=grid)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["lookahead_greedy"] > 0,
              f"grid {family} did not launch the lookahead_greedy kernel")
        launches += counts["lookahead_greedy"]
        alloc = res.final_alloc["CBP"]
        P = len(grid)
        check(res.ipc["CBP"].shape == (P, SCALE_MIXES, N_APPS)
              and np.isfinite(res.ipc["CBP"]).all(),
              f"grid {family}: IPC shape {res.ipc['CBP'].shape} or "
              f"non-finite values")
        check((alloc.cache_units.sum(axis=-1)
               == cfg.total_cache_units).all(),
              f"grid {family}: cache units do not sum to capacity")
        for pi, p in enumerate(grid):
            check((alloc.cache_units[pi] >= p.min_ways).all()
                  and (alloc.bandwidth[pi]
                       >= p.min_bandwidth_allocation - 1e-9).all(),
                  f"grid {family}[{pi}]: an allocation under its floor")
        check(np.allclose(alloc.bandwidth.sum(axis=-1), cfg.total_bandwidth,
                          rtol=1e-9, atol=1e-6),
              f"grid {family}: bandwidth does not sum to capacity")
        worst = 0.0
        small = head(res, SMALL_MIXES)
        for pi, p in enumerate(grid):
            one = run_sweep(mixes[:SMALL_MIXES], managers=["CBP"],
                            total_ms=TOTAL_MS, params=p, config=cfg)
            sliced = type(res)(
                manager_names=["CBP"], mixes=small.mixes,
                ipc={"CBP": small.ipc["CBP"][pi]},
                final_alloc={"CBP": type(alloc)(
                    cache_units=small.final_alloc["CBP"].cache_units[pi],
                    bandwidth=small.final_alloc["CBP"].bandwidth[pi],
                    prefetch_on=small.final_alloc["CBP"].prefetch_on[pi])},
                baseline_ipc=small.baseline_ipc)
            worst = max(worst, compare_sweeps(
                sliced, one, exact_floats=False,
                what=f"grid {family}[{pi}] vs run_sweep(params=p)"))
        ws = res.weighted_speedup("CBP")
        out[family] = {"params": grid_fields, "config": cfg_fields,
                       "wall_s": wall_s,
                       "launches": counts["lookahead_greedy"],
                       "peak_device_gb": peak_gb,
                       "geomeans": [float(g) for g in
                                    np.asarray(res.geomean_speedup("CBP"))],
                       "w1_like_first_mix_ws": [float(x) for x in ws[:, 0]],
                       "max_rel_diff_head_vs_params_run": worst}
        emit(card, phase="grid", family=family, mixes=SCALE_MIXES,
             total_ms=TOTAL_MS, **out[family])
        del res
    return launches


def managers_phase(card: str):
    """``run_all_managers`` on the scalar plant on the card, for w1 and
    for the Fig. 1 pair, against the reference's weighted speedups."""
    import numpy as np
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.sim import (WORKLOADS, CMPConfig, baseline_ipc,
                                 run_all_managers, weighted_speedup)

    launches = 0
    cases = {"w1": (WORKLOADS["w1"], CMPConfig()),
             "fig1": (["lbm", "xalancbmk"],
                      CMPConfig(total_cache_units=64, total_bandwidth=16.0))}
    for label, (apps, cfg) in cases.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run_all_managers(apps, total_ms=TOTAL_MS, config=cfg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        check(counts["lookahead_greedy"] > 0,
              f"managers {label} did not launch the lookahead_greedy kernel")
        launches += counts["lookahead_greedy"]
        base = baseline_ipc(apps, cfg)
        ws = {m: weighted_speedup(r.ipc, base) for m, r in res.items()}
        worst = 0.0
        for name, want in EXPECTED_MANAGER_WS[label].items():
            check(np.isfinite(res[name].ipc).all(),
                  f"managers {label}: non-finite IPC for {name}")
            rel = abs(ws[name] - want) / want
            check(rel <= RTOL, f"managers {label}: weighted speedup of "
                               f"{name} {ws[name]!r} != reference {want!r}")
            worst = max(worst, rel)
        emit(card, phase="managers", workload=label, apps=len(apps),
             total_ms=TOTAL_MS, wall_s=wall_s, launches=counts,
             weighted_speedups=ws, max_rel_diff_vs_reference=worst)
    return launches


def characterization_phase(card: str):
    """Figs. 2-4 on the card: the classification counts, the named
    values against the reference's, and the whole table against the
    port's CPU run."""
    from repro_torch.sim import characterization as ch

    t0 = time.perf_counter()
    table = ch.sensitivity_table()
    classes = {app: ch.classify(row) for app, row in table.items()}
    hmmer = ch.prefetch_vs_allocation("hmmer")
    gcc = ch.prefetch_vs_allocation("gcc")
    fig4 = ch.leslie3d_interactions()
    wall_s = time.perf_counter() - t0
    counts = {}
    for cls in classes.values():
        counts[cls] = counts.get(cls, 0) + 1
    check(counts == EXPECTED_CLASS_COUNTS,
          f"Fig. 2 class counts {counts} != {EXPECTED_CLASS_COUNTS}")
    got = {"xalancbmk P-B": table["xalancbmk"]["P-B"],
           "hmmer P-L": hmmer["P-L"], "hmmer P-B": hmmer["P-B"],
           "gcc P-L": gcc["P-L"], "gcc P-H": gcc["P-H"],
           "fig4d gain": fig4["fig4d"]["gain"],
           "fig4a on": fig4["fig4a"]["on"],
           "table sum": sum(v for row in table.values()
                            for v in row.values())}
    worst = 0.0
    for key, want in EXPECTED_CHARACTERIZATION.items():
        for g, w in zip(*(v if isinstance(v, list) else [v]
                          for v in (got[key], want))):
            rel = abs(g - w) / abs(w)
            check(rel <= RTOL, f"characterization {key}: {g!r} != {w!r}")
            worst = max(worst, rel)
    cpu = ch.sensitivity_table(device="cpu")
    worst_cpu = 0.0
    for app, row in table.items():
        for key, v in row.items():
            rel = abs(v - cpu[app][key]) / max(abs(cpu[app][key]), 1e-300)
            check(rel <= RTOL, f"characterization {app} {key}: card {v!r} "
                               f"!= CPU {cpu[app][key]!r}")
            worst_cpu = max(worst_cpu, rel)
    emit(card, phase="characterization", apps=len(table), wall_s=wall_s,
         class_counts=counts, named=got,
         max_rel_diff_vs_reference=worst, max_rel_diff_vs_cpu=worst_cpu)


# --------------------------------------------------------------------- #
# phase 11: the training-loop binding (fused Fig. 8 knob schedule)
# --------------------------------------------------------------------- #

def load_plant_golden() -> dict:
    """{case: (arguments, {field: array})} of the committed golden."""
    import numpy as np

    dtypes = {"kinds": np.int32, "cache_units": np.int64,
              "prefetch_on": bool}
    data = json.loads(PLANT_GOLDEN.read_text())
    out = {}
    for name, case in data["cases"].items():
        fields = {}
        for f in PLANT_FIELDS:
            v = case["golden"][f]
            if f in PLANT_FLOATS:
                v = np.vectorize(float.fromhex, otypes=[np.float64])(
                    np.asarray(v, dtype=object))
            fields[f] = np.asarray(v, dtype=dtypes.get(f, np.float64))
        out[name] = (case["args"], fields)
    return out


def plant_kwargs(args: dict) -> dict:
    """``run_fused_schedule`` / ``host_reference_run`` keyword arguments
    of one golden case (the model aside)."""
    from repro_torch.core.types import CBPParams, Mode, PrefetchMode

    return dict(
        n_clients=args["n_clients"], total_units=args["total_units"],
        total_bandwidth=args["total_bandwidth"], total_ms=args["total_ms"],
        params=CBPParams(**args["params"]),
        cache_mode=Mode(args.get("cache_mode", "dynamic")),
        bandwidth_mode=Mode(args.get("bandwidth_mode", "dynamic")),
        prefetch_mode=PrefetchMode(args.get("prefetch_mode", "dynamic")))


def plant_diff(got, want: dict, exact: bool, what: str) -> float:
    """Discrete fields equal (dtype too); floats bit for bit, or within
    PLANT_HOST_RTOL.  Returns the largest relative float difference."""
    import numpy as np

    worst = 0.0
    for f in PLANT_FIELDS:
        g, w = getattr(got, f), want[f]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {f} is {g.dtype} {g.shape}, want {w.dtype} "
              f"{w.shape}")
        if f in PLANT_FLOATS:
            check(bool(np.isfinite(g).all()), f"{what}: {f} not finite")
            nz = w != 0
            rel = (float(np.max(np.abs(g[nz] - w[nz]) / np.abs(w[nz])))
                   if nz.any() else 0.0)
            worst = max(worst, rel)
            ok = (np.array_equal(g, w) if exact else
                  np.allclose(g, w, rtol=PLANT_HOST_RTOL, atol=0.0))
        else:
            ok = np.array_equal(g, w)
        check(ok, f"{what}: {f} differs"
                  + ("" if f not in PLANT_FLOATS else f" (max rel {rel})"))
    return worst


def plant_phase(card: str) -> int:
    """Every case of the committed golden on the card, each driven with
    the launch counts reset just before it: the fused schedule (warm-up,
    capture and first replay, then PLANT_WARM_RUNS warm replays) bit for
    bit against the reference's golden and the port's CPU run, one graph
    replay and only the captured greedy launches per warm run; the host
    golden (``host_reference_run``) on the card, discrete fields exact and
    floats within PLANT_HOST_RTOL.  Returns the greedy launches of one
    warm run of every case."""
    import statistics

    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.runtime.plant import (host_reference_run,
                                           run_fused_schedule,
                                           schedule_program)
    from repro_torch.train.plant_model import make_stream_plant_model

    launches_plant = 0
    for name, (args, want) in load_plant_golden().items():
        kw = plant_kwargs(args)

        def model(device):
            return make_stream_plant_model(
                args["n_clients"], args["total_units"],
                args["total_bandwidth"], seed=args["seed"], device=device)

        step_fn, step_model = model("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = run_fused_schedule(step_model, **kw)
        first_s = time.perf_counter() - t0
        plant_diff(first, want, True, f"plant {name}: first run vs golden")
        prog, _kinds, _durs = schedule_program(step_model, **kw)
        graph = prog.graph
        check(graph is not None and graph.captured,
              f"plant {name}: no captured graph on the card")
        walls, counts = [], None
        for _ in range(PLANT_WARM_RUNS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = run_fused_schedule(step_model, **kw)
            walls.append(time.perf_counter() - t0)
            counts = launch_counts()
            want_counts = {k: 0 for k in counts}
            want_counts.update(graph.launches, schedule_graph=1)
            check(counts == want_counts,
                  f"plant {name}: a warm run counted {counts}, not one "
                  f"replay with its captured launches {graph.launches}")
            plant_diff(res, want, True, f"plant {name}: warm run vs golden")
        launches_plant += counts["lookahead_greedy"]
        t0 = time.perf_counter()
        cpu = run_fused_schedule(model("cpu")[1], **kw, device="cpu")
        cpu_s = time.perf_counter() - t0
        plant_diff(res, {f: getattr(cpu, f) for f in PLANT_FIELDS}, True,
                   f"plant {name}: card vs the port's CPU run")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        host = host_reference_run(step_fn, **kw)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        host_launches = launch_counts()["lookahead_greedy"]
        check(host_launches == graph.launches.get("lookahead_greedy", 0),
              f"plant {name}: host golden launched the greedy "
              f"{host_launches} times, the graph {graph.launches}")
        host_rel = plant_diff(host, want, False,
                              f"plant {name}: host_reference_run vs golden")
        emit(card, phase="plant", case=name, args=args,
             segments=len(want["kinds"]),
             bit_identical_to_golden=True, equals_cpu_run=True,
             replays_per_warm_run=counts["schedule_graph"],
             greedy_launches_per_run=counts["lookahead_greedy"],
             warmup_eager_s=graph.seconds["warmup"],
             capture_s=graph.seconds["capture"], first_run_s=first_s,
             warm_replay_median_s=statistics.median(walls),
             warm_replay_min_s=min(walls), warm_replay_max_s=max(walls),
             warm_runs=len(walls), host_reference_run_s=host_s,
             host_greedy_launches=host_launches, cpu_port_run_s=cpu_s,
             host_max_rel_diff=host_rel, host_rtol=PLANT_HOST_RTOL)
    return launches_plant


# --------------------------------------------------------------------- #
# phase 12: Fig. 5's static search
# --------------------------------------------------------------------- #

def load_static_golden() -> dict:
    """{case: (arguments, golden)} of the committed static-search golden:
    the workloads, and per family the top-k arrays (``int64`` indices)."""
    import numpy as np

    def floats(v):
        return np.vectorize(float.fromhex, otypes=[np.float64])(
            np.asarray(v, dtype=object))

    data = json.loads(STATIC_GOLDEN.read_text())
    out = {}
    for name, case in data["cases"].items():
        g = case["golden"]
        families = {
            fam: {key: (np.asarray(v, dtype=np.int64)
                        if key == "topk_index" else floats(v))
                  for key, v in arrays.items()}
            for fam, arrays in g["families"].items()}
        out[name] = (case["args"], {"workloads": g["workloads"],
                                    "families": families,
                                    "geomeans": g["geomeans"]})
    return out


def static_run(args: dict, **kw):
    """The port's search on the card for one golden case, synchronised."""
    import torch
    from repro_torch.sim import static_search as ss
    from repro_torch.sim.workloads import random_workloads

    fams = (ss.FIG5_FAMILIES if args["families"] == "fig5"
            else ss.registry_families())
    res = ss.search_static(
        random_workloads(args["n_workloads"], args["apps"], args["seed"]),
        {name: fams[name] for name in args.get("only", fams)},
        k=args["k"], multi_objective=args["multi_objective"], **kw)
    torch.cuda.synchronize()
    return res


def static_banks(family: str) -> int:
    from repro_torch.sim import static_search as ss

    return {**ss.FIG5_FAMILIES,
            **ss.registry_families()}[family].bandwidth_banks


def static_index_rule(res, want: dict, what: str):
    """Every slot's index equals the golden's or names its twin; weighted
    speedups within STATIC_WS_RTOL.  Returns the twin picks per family
    and the largest relative ws distance."""
    import numpy as np
    from repro_torch.sim.static_search import is_twin

    check(res.workloads == want["workloads"], f"{what}: other workloads")
    twins, worst = {}, 0.0
    for fam, w in want["families"].items():
        got, ref = res.topk_index[fam], w["topk_index"]
        check(got.dtype == np.int64 and got.shape == ref.shape,
              f"{what} {fam}: indices {got.dtype} {got.shape}")
        twins[fam] = 0
        for wi in range(ref.shape[0]):
            for g, r in zip(got[wi].tolist(), ref[wi].tolist()):
                check(is_twin(res.grids[fam], want["workloads"][wi], r, g),
                      f"{what} {fam} workload {wi}: index {g} is neither "
                      f"the golden's {r} nor its twin")
                twins[fam] += int(g != r)
        g_ws, w_ws = res.topk_ws[fam], w["topk_ws"]
        finite = np.isfinite(w_ws)
        check(np.array_equal(np.isfinite(g_ws), finite),
              f"{what} {fam}: empty slots differ")
        rel = float(np.max(np.abs(g_ws[finite] / w_ws[finite] - 1.0)))
        check(rel <= STATIC_WS_RTOL, f"{what} {fam}: weighted speedup off "
                                     f"the golden by {rel} (rtol "
                                     f"{STATIC_WS_RTOL})")
        worst = max(worst, rel)
    return twins, worst


def static_own_order(res, what: str) -> None:
    """Each family's top-k equals the stable descending argsort (numpy's,
    on the host) of the card's own scores of the whole grid, bit for
    bit: the chunked fold and its tie-break, whatever the rounding."""
    import numpy as np
    from repro_torch.sim.static_search import _grid_scores

    for fam in res.family_names:
        scores = _grid_scores(res.workloads, res.grids[fam],
                              static_banks(fam)).cpu().numpy()
        order = np.argsort(-scores, axis=-1, kind="stable")[:, :res.k]
        got_idx, got_ws = res.topk_index[fam], res.topk_ws[fam]
        m = order.shape[1]
        check(np.array_equal(got_idx[:, :m], order)
              and np.array_equal(got_ws[:, :m],
                                 np.take_along_axis(scores, order, -1))
              and (got_idx[:, m:] == -1).all(),
              f"{what} {fam}: top-k is not the card's own first maxima")


def static_phase(card: str) -> int:
    """Fig. 5's static search on the card against the numpy golden, with
    the launch counts reset just before and read just after: the smoke
    configuration (cold and two warm runs), its workloads over the
    registry's families, the 640-workload study (cold and warm) and the
    Pareto case.  Returns the greedy's launches (none)."""
    import numpy as np
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.sim import static_search as ss

    golden = load_static_golden()
    torch.cuda.synchronize()
    reset_launch_counts()

    def timed(args, runs: int):
        walls, peak = [], 0
        for i in range(runs):
            torch.cuda.synchronize()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = static_run(args)
            walls.append(time.perf_counter() - t0)
        if runs > 1:
            peak = torch.cuda.max_memory_allocated()
        return res, walls, peak

    for name in ("smoke", "smoke_registry"):
        args, want = golden[name]
        res, walls, peak = timed(args, 3 if name == "smoke" else 1)
        twins, rel = static_index_rule(res, want, f"static {name}")
        static_own_order(res, f"static {name}")
        extra = {}
        if name == "smoke":
            geo = res.geomean("cache+bw+pref")
            check(round(geo, 3) == FIG5_GEO_ALL3,
                  f"static smoke: geo_all3 {geo!r} does not round to the "
                  f"record's {FIG5_GEO_ALL3}")
            extra = {"warm_s": min(walls[1:]), "warm_runs_s": walls[1:],
                     "peak_bytes": peak, "geo_all3": geo,
                     "geo_all3_golden": want["geomeans"]["cache+bw+pref"],
                     "geo_all3_record": FIG5_GEO_ALL3}
        emit(card, phase="static", case=name, args=args,
             families=len(res.family_names), cold_s=walls[0], **extra,
             twin_picks=twins, max_rel_ws_vs_golden=rel,
             ws_rtol=STATIC_WS_RTOL, own_order_bit_identical=True)

    args, want = golden["study"]
    res, walls, peak = timed(args, 2)
    twins, rel = static_index_rule(res, want, "static study")
    w_count = args["n_workloads"]
    chunks = {fam: list(ss._family_tables(
        res.grids[fam], w_count, args["k"], ss.CHUNK_ELEMENTS)["valid"].shape)
        for fam in res.family_names}
    geo = {fam: res.geomean(fam) for fam in res.family_names}
    geo_golden = want["geomeans"]
    frac = {fam: res.frac_at_least(fam, 1.10) for fam in res.family_names}
    frac_golden = {fam: float(np.mean(w["topk_ws"][:, 0] >= 1.10))
                   for fam, w in want["families"].items()}

    def all3_vs_best2(g):
        return g["cache+bw+pref"] / max(g[f] for f in ss.FIG5_TWO_RESOURCE) \
            - 1.0

    emit(card, phase="static", case="study", args=args, cold_s=walls[0],
         warm_s=walls[1], peak_bytes=peak, chunks_per_family=chunks,
         twin_picks=twins, max_rel_ws_vs_golden=rel,
         ws_rtol=STATIC_WS_RTOL, geomeans=geo, geomeans_golden=geo_golden,
         frac_at_least_1_10=frac, frac_at_least_1_10_golden=frac_golden,
         all3_vs_best2=all3_vs_best2(geo),
         all3_vs_best2_golden=all3_vs_best2(geo_golden))

    args, want = golden["pareto"]
    res = static_run(args)
    worst = 0.0
    for fam, w in want["families"].items():
        check(np.array_equal(res.topk_index[fam], w["topk_index"]),
              f"static pareto {fam}: indices differ from the golden's")
        for key in ("topk_ws", "topk_fairness"):
            g = {"topk_ws": res.topk_ws, "topk_fairness":
                 res.topk_fairness}[key][fam]
            finite = np.isfinite(w[key])
            check(np.array_equal(np.isfinite(g), finite),
                  f"static pareto {fam}: empty slots differ")
            rel = float(np.max(np.abs(g[finite] / w[key][finite] - 1.0)))
            check(rel <= STATIC_PARETO_RTOL,
                  f"static pareto {fam} {key}: off the golden by {rel}")
            worst = max(worst, rel)
    counts = launch_counts()
    check(counts["lookahead_greedy"] == 0,
          f"static: the search launched the greedy {counts}")
    emit(card, phase="static", case="pareto", args=args,
         indices_equal=True, max_rel_vs_golden=worst,
         rtol=STATIC_PARETO_RTOL, launches=counts)
    return counts["lookahead_greedy"]


# --------------------------------------------------------------------- #
# phase 13: the fault-tolerant streaming sweep
# --------------------------------------------------------------------- #

def load_stream_golden() -> dict:
    """{case: {"config", "fingerprint", "runs": {run: {"plan",
    "aggregates", "report", "quarantined"}}}} of the committed stream
    golden, the float aggregates as float64 arrays."""
    import numpy as np

    data = json.loads(STREAM_GOLDEN.read_text())
    for case in data["cases"].values():
        for run in case["runs"].values():
            run["aggregates"] = {
                k: (np.vectorize(float.fromhex, otypes=[np.float64])(
                    np.asarray(v, dtype=object))
                    if k in ("log_ws_sum", "max_slowdown", "min_fairness")
                    else np.asarray(v, dtype=np.int64))
                for k, v in run["aggregates"].items()}
    return data["cases"]


def stream_config(args: dict, **kw):
    """The port's ``StreamConfig`` of one golden case."""
    from repro_torch.sim.stream_sweep import StreamConfig
    from repro_torch.sim.workloads import StreamScenario

    fields = {k: v for k, v in args.items() if k != "scenario"}
    if fields.get("managers") is not None:
        fields["managers"] = tuple(fields["managers"])
    return StreamConfig(**fields, scenario=StreamScenario(**args["scenario"]),
                        **kw)


def stream_check(report, run: dict, what: str) -> float:
    """Counts, quarantined chunks, coverage and retries equal to the
    golden run; the float aggregates within STREAM_RTOL (``log_ws_sum``
    of a manager whose weighted speedups are 1 up to rounding: within one
    ulp of 1.0 per mix).  Returns the largest relative distance held by
    STREAM_RTOL."""
    import numpy as np

    tree, want = report.aggregates.to_tree(), run["aggregates"]
    for key in ("mix_count", "slowdown_hist"):
        check(np.array_equal(tree[key], want[key]),
              f"{what}: {key} differs from the golden")
    check([c for c, _ in report.quarantined] == run["quarantined"],
          f"{what}: quarantined {report.quarantined} != golden chunks "
          f"{run['quarantined']}")
    for key in ("coverage", "mixes_covered", "retries"):
        check(getattr(report, key) == run["report"][key],
              f"{what}: {key} {getattr(report, key)} != golden "
              f"{run['report'][key]}")
    worst = 0.0
    eps = float(np.finfo(np.float64).eps)
    for key in ("log_ws_sum", "max_slowdown", "min_fairness"):
        got, ref = tree[key], want[key]
        diff, scale = np.abs(got - ref), np.abs(ref)
        floor = want["mix_count"] * eps if key == "log_ws_sum" else 0.0
        check(bool((diff <= np.maximum(STREAM_RTOL * scale, floor)).all()),
              f"{what}: {key} {got.tolist()} off the golden {ref.tolist()}")
        held = (STREAM_RTOL * scale >= floor) & (scale > 0)
        if held.any():
            worst = max(worst, float((diff[held] / scale[held]).max()))
    return worst


def stream_same(a, b) -> bool:
    import numpy as np

    ta, tb = a.aggregates.to_tree(), b.aggregates.to_tree()
    return all(np.array_equal(ta[k], tb[k], equal_nan=True) for k in ta)


def stream_healthy(report, what: str) -> None:
    check(report.coverage == 1.0 and report.retries == 0
          and report.quarantined == [],
          f"{what}: a healthy run reported coverage {report.coverage}, "
          f"{report.retries} retries, quarantined {report.quarantined}")


def stream_phase(card: str) -> int:
    """The streaming sweep on the card, with the launch counts reset just
    before its first stream and read after its last: the bench smoke
    (overlapped, serial, the kill-free plan, the resume-parity gate) and
    the full head (its first chunk's greedy launches alone, its 1-chunk
    prefix, serial and overlapped).  Returns the greedy's launches."""
    import tempfile

    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.runtime.faultinject import FaultPlan, InjectedProcessKill
    from repro_torch.sim.stream_sweep import _StreamRunner, run_stream

    golden = load_stream_golden()
    no_sleep = lambda s: None  # noqa: E731

    def greedy() -> int:
        return launch_counts()["lookahead_greedy"]

    def timed(cfg, **kw):
        torch.cuda.synchronize()
        before = greedy()
        t0 = time.perf_counter()
        report = run_stream(cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        return report, time.perf_counter() - t0, greedy() - before

    torch.cuda.synchronize()
    reset_launch_counts()

    # ---- the bench smoke ------------------------------------------- #
    g = golden["bench_smoke"]
    cfg = stream_config(g["config"])
    overlapped, wall_ov, launch_ov = timed(cfg, overlap=True)
    serial, wall_se, launch_se = timed(cfg, overlap=False)
    for rep, what in ((overlapped, "overlapped"), (serial, "serial")):
        stream_healthy(rep, f"stream bench_smoke {what}")
    rel = stream_check(overlapped, g["runs"]["healthy"],
                       "stream bench_smoke")
    check(stream_same(overlapped, serial),
          "stream bench_smoke: overlapped and serial aggregates differ")
    geo = overlapped.geomean_ws["CBP"]
    check(geo == STREAM_CBP_RECORD,
          f"stream bench_smoke: CBP geomean {geo} does not round to the "
          f"record's {STREAM_CBP_RECORD}")
    plan = FaultPlan.from_dicts(STREAM_PARITY_PLAN)
    clean, _, _ = timed(cfg, fault_plan=plan.without_kills(),
                        sleep_fn=no_sleep)
    rel = max(rel, stream_check(clean, g["runs"]["faults"],
                                "stream bench_smoke faults"))
    with tempfile.TemporaryDirectory() as tmp:
        ck = stream_config(g["config"], checkpoint_dir=f"{tmp}/ck",
                           checkpoint_every=1)
        killed = False
        try:
            run_stream(ck, fault_plan=plan, sleep_fn=no_sleep,
                       device="cuda")
        except InjectedProcessKill:
            killed = True
        check(killed, "stream resume gate: the injected kill did not fire")
        resumed = run_stream(ck, fault_plan=plan.without_kills(),
                             resume=True, sleep_fn=no_sleep, device="cuda")
    check(resumed.resumed_from is not None,
          "stream resume gate: no checkpoint was restored")
    check(stream_same(resumed, clean),
          "stream resume gate: resumed aggregates differ from the clean "
          "run's")
    check([c for c, _ in resumed.quarantined] == [1]
          and resumed.coverage == 0.75 and resumed.retries >= 1
          and "mix" in resumed.quarantined[0][1],
          f"stream resume gate: quarantined {resumed.quarantined}, "
          f"coverage {resumed.coverage}, retries {resumed.retries}")
    emit(card, phase="stream", case="bench_smoke", config=g["config"],
         wall_overlap_s=wall_ov, wall_serial_s=wall_se,
         launches_overlap=launch_ov, launches_serial=launch_se,
         cbp_geomean_ws=geo, cbp_geomean_record=STREAM_CBP_RECORD,
         max_rel_vs_golden=rel, rtol=STREAM_RTOL,
         overlap_bit_identical=True,
         resume={"resumed_from": resumed.resumed_from,
                 "quarantined": [c for c, _ in resumed.quarantined],
                 "coverage": resumed.coverage,
                 "retries": resumed.retries, "bit_identical": True})

    # ---- the full head --------------------------------------------- #
    g = golden["full_head"]
    cfg = stream_config(g["config"])
    runner = _StreamRunner(cfg, None, False, time.sleep,
                           torch.device("cuda"))
    torch.cuda.synchronize()
    before = greedy()
    with runner.on_device():
        pending, _base = runner.dispatch(runner._generate(0))
        pending.block_until_ready()
    one_chunk = greedy() - before
    del runner, pending, _base
    check(one_chunk > 0, "stream full_head: the first chunk launched no "
                         "greedy")

    prefix = stream_config({**g["config"],
                            "n_mixes": g["config"]["chunk_size"]})
    # Peaks as max_memory_allocated gives them, and net of what earlier
    # phases leave allocated (resident), both bounded.
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timed(prefix, overlap=False)
    peak_one = torch.cuda.max_memory_allocated()
    walls, peaks, launches, reports = {}, {}, {}, {}
    for mode, overlap in (("serial", False), ("overlap", True)):
        torch.cuda.reset_peak_memory_stats()
        reports[mode], walls[mode], launches[mode] = timed(
            cfg, overlap=overlap)
        peaks[mode] = torch.cuda.max_memory_allocated()
        stream_healthy(reports[mode], f"stream full_head {mode}")
        check(launches[mode] == cfg.n_chunks * one_chunk,
              f"stream full_head {mode}: {launches[mode]} greedy launches, "
              f"not {cfg.n_chunks} x {one_chunk}")
        check(peaks[mode] <= STREAM_PEAK_RATIO * peak_one
              and peaks[mode] - resident
              <= STREAM_PEAK_RATIO * (peak_one - resident),
              f"stream full_head {mode}: peak {peaks[mode]} bytes over "
              f"{STREAM_PEAK_RATIO} x the 1-chunk prefix's {peak_one} "
              f"({resident} resident before both)")
    rel = stream_check(reports["serial"], g["runs"]["healthy"],
                       "stream full_head")
    check(stream_same(reports["serial"], reports["overlap"]),
          "stream full_head: overlapped and serial aggregates differ")
    counts = launch_counts()
    emit(card, phase="stream", case="full_head", config=g["config"],
         chunks=cfg.n_chunks, wall_serial_s=walls["serial"],
         wall_overlap_s=walls["overlap"],
         mixes_per_s={k: cfg.n_mixes / v for k, v in walls.items()},
         greedy_launches=launches, greedy_launches_first_chunk=one_chunk,
         peak_bytes=peaks, peak_bytes_one_chunk=peak_one,
         resident_bytes=resident, peak_ratio_bound=STREAM_PEAK_RATIO,
         cbp_geomean_ws=reports["serial"].geomean_ws["CBP"],
         max_rel_vs_golden=rel, rtol=STREAM_RTOL,
         overlap_bit_identical=True, launches=counts)
    check(counts["lookahead_greedy"] > 0, "stream: the greedy never ran")
    return counts["lookahead_greedy"]


# --------------------------------------------------------------------- #
# phase 14: the model stack (repro_torch.models, repro_torch.configs)
# --------------------------------------------------------------------- #

#: (a) the card against the port's CPU run, smoke configs in float32 with
#: TF32 off: the CPU tests' bound against the JAX package, unless the CPU
#: run's own spread (its distance to itself with every parameter one ulp
#: up) passes it (ROADMAP R4: zamba2-7b alone).
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
#: Where the spread passes MODEL_ATOL (zamba2-7b), the bound is this many
#: spreads: the card's float32 ops differ from the CPU's by a few ulps
#: each, the spread's nudge moves each parameter by one.
R4_FACTOR = 4
SMOKE_B, SMOKE_S, SMOKE_T = 2, 32, 12
#: Decode against the full forward: float32 at ``test_decode_parity``'s
#: 2e-3; bfloat16 at the bound PERF.md §6 states, set before the model
#: stack first ran on a card: max and mean |decode - forward| over the
#: logits, and the share of positions whose argmax agrees.
PARITY_F32 = 2e-3
BF16_MAX, BF16_MEAN, ARGMAX_FLOOR = 0.5, 0.05, 0.8
#: (b) qwen3-8b at its full config: 4 requests of 2,048 prompt tokens,
#: 32 greedy steps against a cache of 2,080 positions, decode against
#: the forward on the first 16 positions.
QWEN_B, QWEN_PROMPT, QWEN_STEPS, QWEN_PARITY = 4, 2048, 32, 16
#: Greedy steps run once more under the profiler: device time a step
#: over the unprofiled wall a step is the card's busy share in decode.
QWEN_PROFILED = 8
#: (c) the other nine at full width, cut in depth only: 2 layers, zamba2-7b
#: 7 (two shared-attention sites), whisper-tiny whole; 2 requests of 512
#: tokens (whisper: 1,500 frames and 448 tokens), 8 decode steps.
FULL_LAYERS = {"zamba2-7b": 7, "whisper-tiny": None}
FULL_B, FULL_PROMPT, FULL_STEPS = 2, 512, 8
#: mamba2-1.3b and zamba2-7b scan in chunks of 16 (their smoke configs'),
#: not 128: the reference's chunked SSD takes exp(cs_i - cs_j) above the
#: diagonal before its causal mask, which overflows once a chunk's decay
#: passes e^88, and inf x 0 is NaN (ROADMAP R5; the port does the same).
#: The chunk length is a numerics setting: the scan is exact in any.
FULL_SSM_CHUNK = 16
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
#: Where phase 14 runs its models (a CPU rehearsal sets "cpu").
DEVICE = "cuda"


def model_inputs(cfg, b: int, s: int, device, seed: int = 0,
                 frames: int = 0) -> dict:
    """A batch drawn with numpy: tokens and next-token labels (the last
    masked), frames for the encoder-decoder, embeddings for stub
    frontends, in the parameter dtype."""
    import numpy as np
    import torch
    from repro_torch.models.layers import torch_dtype

    rng = np.random.default_rng(seed)
    dt = torch_dtype(cfg.param_dtype)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1)], 1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, frames or s, cfg.d_model))
    if cfg.frontend in ("audio", "patch") and cfg.family != "encdec":
        batch = {"embeddings": rng.standard_normal((b, s, cfg.d_model)),
                 "labels": labels}
    return {k: torch.as_tensor(v, device=device,
                               dtype=dt if v.dtype.kind == "f" else None)
            for k, v in batch.items()}


def prepared_cache(model, batch, max_len: int, cache_dtype):
    """An empty decode cache for the batch; whisper's holds the cross K/V
    of the encoded frames (``encdec.cross_kv``), and at least their
    positions."""
    import torch
    from repro_torch.models import encdec

    cfg = model.cfg
    steps = batch["embeddings" if "embeddings" in batch else "tokens"]
    if cfg.family != "encdec":
        return model.init_cache(steps.shape[0], max_len, dtype=cache_dtype)
    m = batch["frames"].shape[1]
    cache = model.init_cache(steps.shape[0], max(max_len, m),
                             dtype=cache_dtype)
    hidden = encdec.encode(model.params, cfg, batch["frames"])
    xk, xv = encdec.cross_kv(model.params, cfg, hidden)
    cache["xk"][:, :, :m], cache["xv"][:, :, :m] = xk, xv
    cache["enc_len"] = torch.tensor(m, dtype=torch.int32, device=model.device)
    return cache


def run_steps(model, batch, cache, n: int, positions=None):
    """Logits (B, n, V) of the batch's first ``n`` tokens (or embeddings)
    fed one at a time; ``positions`` per step (default 0 .. n-1)."""
    import torch

    steps = batch["embeddings" if "embeddings" in batch else "tokens"]
    outs = []
    for i in range(n):
        pos = i if positions is None else positions[i]
        logits, cache = model.decode_step(cache, steps[:, i:i + 1], pos)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def decode_steps(model, batch, n: int, max_len: int, cache_dtype,
                 positions=None):
    return run_steps(model, batch,
                     prepared_cache(model, batch, max_len, cache_dtype),
                     n, positions)


def nudged(model):
    """The model with every float parameter one ulp up."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_map

    return Model(model.cfg, tree_map(
        lambda t: torch.nextafter(t, torch.full_like(t, float("inf")))
        if t.is_floating_point() else t.clone(), model.params))


def smoke_run(model, batch, vector: bool) -> dict:
    """Loss, prefill and 12 decode steps (and, with ``vector``, the same
    steps with a per-row ``cur_len``, row 1 two positions ahead)."""
    import torch

    out = {"loss": model.loss(batch), "prefill": model.prefill(batch),
           "decode": decode_steps(model, batch, SMOKE_T, SMOKE_T + 4,
                                  torch.float32)}
    if vector:
        out["decode_vector"] = decode_steps(
            model, batch, SMOKE_T, SMOKE_T + 4, torch.float32,
            [[i, i + 2] for i in range(SMOKE_T)])
    return {k: v.float().cpu() for k, v in out.items()}


def moe_routes(model, device, seed: int = 3) -> dict:
    """Layer 0's routing of a seeded input at the config's capacity and at
    capacity factor 0.5 (every expert overflows: ROADMAP R3)."""
    import dataclasses

    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, SMOKE_B * SMOKE_S, cfg.d_model, generator=g)
    lp = {k: v.to(device) for k, v in L.layer(
        model.params["layers"]["moe"], 0).items()}
    out = {}
    for cf in (cfg.capacity_factor, 0.5):
        route = transformer.moe_route(
            lp, dataclasses.replace(cfg, capacity_factor=cf), x.to(device))
        out[cf] = (route.experts.cpu(), route.slots.cpu())
    return out


def models_smoke(card: str) -> dict:
    """(a) Every smoke config built from a seed on the CPU and copied to
    the card: the card's loss, prefill and decode equal the CPU's within
    MODEL_RTOL and the larger of MODEL_ATOL and the CPU's own one-ulp
    spread; MoE routing and kept slots exactly equal."""
    import copy

    import torch
    from repro_torch import configs
    from repro_torch.models import build

    worst = {}
    for name in configs.names():
        cfg = configs.get_smoke(name)
        cpu = build(cfg, device="cpu", seed=0)
        card_model = copy.deepcopy(cpu).to(DEVICE)
        vector = name == "qwen3-8b"
        want = smoke_run(cpu, model_inputs(cfg, SMOKE_B, SMOKE_S, "cpu"),
                         vector)
        spread = {k: float((v - want[k]).abs().max()) for k, v in smoke_run(
            nudged(cpu), model_inputs(cfg, SMOKE_B, SMOKE_S, "cpu"),
            vector).items()}
        got = smoke_run(card_model,
                        model_inputs(cfg, SMOKE_B, SMOKE_S, DEVICE), vector)
        errs = {}
        for key, w in want.items():
            atol = (MODEL_ATOL if spread[key] <= MODEL_ATOL
                    else R4_FACTOR * spread[key])
            excess = float(((got[key] - w).abs()
                            - MODEL_RTOL * w.abs()).max())
            errs[key] = float((got[key] - w).abs().max())
            check(excess <= atol, f"models {name} {key}: card vs CPU "
                  f"{errs[key]:.3g} past atol {atol:.3g} + rtol "
                  f"{MODEL_RTOL}")
        routes = {}
        if cfg.n_experts:
            for (cf, (e_cpu, s_cpu)), (e_gpu, s_gpu) in zip(
                    moe_routes(cpu, "cpu").items(),
                    moe_routes(cpu, DEVICE).values()):
                check(torch.equal(e_cpu, e_gpu) and torch.equal(s_cpu, s_gpu),
                      f"models {name}: card routing differs at cf {cf}")
                counts = torch.bincount(e_cpu.reshape(-1),
                                        minlength=cfg.n_experts)
                routes[cf] = {"capacity": s_cpu.shape[-1],
                              "overflowing_experts":
                                  int((counts > s_cpu.shape[-1]).sum())}
            check(routes[0.5]["overflowing_experts"] > 0,
                  f"models {name}: no expert overflows at cf 0.5")
        worst[name] = errs
        emit(card, phase="models", case="smoke", config=name,
             max_abs_card_vs_cpu=errs, cpu_one_ulp_spread=spread,
             rtol=MODEL_RTOL, atol=MODEL_ATOL, moe_routes_equal=routes)
        del card_model
    return worst


def parity(dec, fwd, dtype) -> dict:
    """Decode against the forward: max and mean |diff|, argmax agreement;
    raises past the bound of ``dtype``."""
    import torch

    diff = (dec.float() - fwd.float()).abs()
    rec = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
           "argmax_agree": float((dec.argmax(-1) == fwd.argmax(-1))
                                 .float().mean()),
           "positions": int(dec.shape[0] * dec.shape[1])}
    if dtype == torch.float32:
        rec["ok"] = bool((diff <= PARITY_F32 * (1 + fwd.float().abs()))
                         .all())
    else:
        rec["ok"] = (rec["max_abs"] <= BF16_MAX
                     and rec["mean_abs"] <= BF16_MEAN
                     and rec["argmax_agree"] >= ARGMAX_FLOOR)
    return rec


def fill_kv(model, tokens, cache) -> None:
    """Write the prompt's rotated K and V of every layer into the cache's
    first positions, from the forward's own layer inputs (what decode
    steps over the prompt would write): the cache the greedy steps
    continue from."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, params = model.cfg, model.params
    x = T.embed(params, cfg, tokens)
    s = tokens.shape[1]
    positions = torch.arange(s, device=x.device)
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        _, k, v = T._project_qkv(lp["attn"], cfg, h)
        cache["k"][i, :, :s] = L.apply_rope(k, positions, cfg.rope_theta)
        cache["v"][i, :, :s] = v
        x = T._layer(lp, cfg, x, positions)


def synced_wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def qwen_full(card: str) -> dict:
    """(b) qwen3-8b at its full config on the card."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build

    cfg = configs.get("qwen3-8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, build_s = synced_wall(lambda: build(cfg, DEVICE, seed=0))
    batch = model_inputs(cfg, QWEN_B, QWEN_PROMPT, DEVICE, seed=1)
    toks = batch["tokens"]
    prefill, cold_s = synced_wall(lambda: model.prefill(batch))
    prefill, warm_s = synced_wall(lambda: model.prefill(batch))
    check(bool(torch.isfinite(prefill).all()), "qwen3-8b prefill not finite")
    max_len = QWEN_PROMPT + QWEN_STEPS
    cache = model.init_cache(QWEN_B, max_len)
    _, fill_s = synced_wall(
        lambda: fill_kv(model, toks[:, :QWEN_PROMPT - 1], cache))
    # the prompt's last token at position 2047 reproduces the prefill
    first, cache = model.decode_step(cache, toks[:, -1:], QWEN_PROMPT - 1)
    long_ctx = parity(first[:, :1], prefill, torch.bfloat16)

    def greedy(n: int):
        """``n`` greedy steps from the cache after position 2047 (decode
        is functional: ``cache`` itself stays as it is)."""
        c, tok, out = cache, first[:, 0].argmax(-1, keepdim=True), []
        for i in range(n):
            logits, c = model.decode_step(c, tok, QWEN_PROMPT + i)
            tok = logits[:, 0].argmax(-1, keepdim=True)
            out.append(logits)
        return torch.cat(out, dim=1)

    steps, decode_s = synced_wall(lambda: greedy(QWEN_STEPS))
    check(bool(torch.isfinite(steps).all()), "qwen3-8b decode not finite")
    prof = device_profile(lambda: greedy(QWEN_PROFILED))
    prof["busy_share"] = (prof["device_s"] / (QWEN_PROFILED * decode_s
                                              / QWEN_STEPS)
                          if prof["device_s"] else None)
    fwd = model.logits({"tokens": toks[:, :QWEN_PARITY]})
    dec = decode_steps(model, {"tokens": toks[:, :QWEN_PARITY]},
                       QWEN_PARITY, max_len, torch.bfloat16)
    rec = parity(dec, fwd, torch.bfloat16)
    check(rec["ok"], f"qwen3-8b decode vs forward: {rec}")
    check(long_ctx["max_abs"] <= BF16_MAX
          and long_ctx["mean_abs"] <= BF16_MEAN,
          f"qwen3-8b decode at {QWEN_PROMPT - 1} vs prefill: {long_ctx}")
    out = {"config": cfg.name, "param_dtype": cfg.param_dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "padded_vocab": cfg.padded_vocab,
           "weight_bytes": weight_bytes(model), "build_s": build_s,
           "batch": QWEN_B, "prompt": QWEN_PROMPT,
           "prefill_cold_s": cold_s, "prefill_warm_s": warm_s,
           "prefill_tokens_per_s": QWEN_B * QWEN_PROMPT / warm_s,
           "fill_kv_s": fill_s, "decode_steps": QWEN_STEPS,
           "cache_positions": max_len, "decode_wall_s": decode_s,
           "decode_ms_per_step": 1e3 * decode_s / QWEN_STEPS,
           "decode_tokens_per_s": QWEN_B * QWEN_STEPS / decode_s,
           "decode_profile": prof,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "decode_vs_forward": rec, "decode_at_2047_vs_prefill": long_ctx,
           "tolerance": {"max_abs": BF16_MAX, "mean_abs": BF16_MEAN,
                         "argmax_floor": ARGMAX_FLOOR}}
    emit(card, phase="models", case="qwen3-8b_full", **out)
    del model, cache
    torch.cuda.empty_cache()
    return out


def full_width(card: str, name: str) -> dict:
    """(c) One full-width config cut in depth: prefill, 8 timed decode
    steps, and decode against the forward over those 8 tokens in bf16.
    The dense, VLM and SSM configs take the bf16 gate whole.  MoE (at the
    drop-free capacity E / k, as the parity test) flips a near-tied expert
    where bf16 rounding differs, so its bf16 run is held to the mean and
    argmax only, and the same weights in float32 to 2e-3; zamba2-7b's bf16
    decode departs from its forward in the reference too (R4), so it is
    held in float32 alone.  Whisper at position 0, its decode's only
    position with the forward's sinusoid."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import Model, build

    cfg = configs.get(name)
    layers = FULL_LAYERS.get(name, 2)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=FULL_SSM_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, build_s = synced_wall(lambda: build(cfg, DEVICE, seed=0))
    wbytes = weight_bytes(model)
    encdec = cfg.family == "encdec"
    s = WHISPER_TOKENS if encdec else FULL_PROMPT
    batch = model_inputs(cfg, FULL_B, s, DEVICE, seed=2,
                         frames=WHISPER_FRAMES if encdec else 0)
    prefill, cold_s = synced_wall(lambda: model.prefill(batch))
    prefill, warm_s = synced_wall(lambda: model.prefill(batch))
    check(bool(torch.isfinite(prefill).all()), f"{name} prefill not finite")
    head = {k: v[:, :FULL_STEPS] if k != "frames" else v
            for k, v in batch.items()}
    cache = prepared_cache(model, head, FULL_STEPS, torch.bfloat16)
    steps, decode_s = synced_wall(lambda: run_steps(model, head, cache,
                                                    FULL_STEPS))
    check(bool(torch.isfinite(steps).all()), f"{name} decode not finite")
    peak = torch.cuda.max_memory_allocated()
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.padded_experts / cfg.top_k)

    def decode_vs_forward(m, inputs, dtype):
        dec = decode_steps(m, inputs, FULL_STEPS, FULL_STEPS, dtype)
        if encdec:
            return parity(dec[:, :1], m.logits(
                {"frames": inputs["frames"],
                 "tokens": inputs["tokens"][:, :1]}), dtype)
        return parity(dec, m.logits(inputs), dtype)

    rec = {"bfloat16": decode_vs_forward(Model(cfg, model.params), head,
                                         torch.bfloat16)}
    if cfg.n_experts or name == "zamba2-7b":
        if cfg.n_experts:
            bf = rec["bfloat16"]
            check(bf["mean_abs"] <= BF16_MEAN
                  and bf["argmax_agree"] >= ARGMAX_FLOOR,
                  f"{name} bf16 decode vs forward: {bf}")
        model.float()        # in place: the bf16 weights go
        f32 = Model(dataclasses.replace(cfg, param_dtype="float32"),
                    model.params)
        rec["float32"] = decode_vs_forward(
            f32, {k: v.float() if v.is_floating_point() else v
                  for k, v in head.items()}, torch.float32)
        check(rec["float32"]["ok"], f"{name} f32 decode vs forward: {rec}")
        del f32
    else:
        check(rec["bfloat16"]["ok"], f"{name} decode vs forward: {rec}")
    out = {"config": name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "ssm_chunk": cfg.ssm_chunk if cfg.ssm_state else None,
           "depth_cut_from": configs.get(name).n_layers,
           "weight_bytes": wbytes,
           "build_s": build_s, "batch": FULL_B, "prompt": s,
           "frames": WHISPER_FRAMES if encdec else None,
           "prefill_cold_s": cold_s, "prefill_warm_s": warm_s,
           "prefill_tokens_per_s": FULL_B * s / warm_s,
           "decode_steps": FULL_STEPS, "decode_wall_s": decode_s,
           "decode_tokens_per_s": FULL_B * FULL_STEPS / decode_s,
           "peak_bytes": peak,
           "peak_bytes_with_checks": torch.cuda.max_memory_allocated(),
           "decode_vs_forward": rec}
    emit(card, phase="models", case="full_width", **out)
    del model
    torch.cuda.empty_cache()
    return out


def models_phase(card: str) -> dict:
    """Phase 14, with the launch counts reset just before it and read just
    after: the model stack launches no hand-written kernel (the reference
    models call none)."""
    from repro_torch import configs
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()
    smoke = models_smoke(card)
    qwen = qwen_full(card)
    full = [full_width(card, name) for name in configs.names()
            if name != "qwen3-8b"]
    counts = launch_counts()
    check(not any(counts.values()),
          f"models: a hand-written kernel launched: {counts}")
    seconds = time.perf_counter() - t0
    emit(card, phase="models", case="summary", seconds=seconds,
         launches=counts, smoke_configs=len(smoke),
         qwen3_8b_prefill_tokens_per_s=qwen["prefill_tokens_per_s"],
         qwen3_8b_decode_tokens_per_s=qwen["decode_tokens_per_s"],
         qwen3_8b_peak_bytes=qwen["peak_bytes"],
         full_width={r["config"]: r["peak_bytes"] for r in full})
    return counts


# --------------------------------------------------------------------- #
# phase 15: the serving path
# --------------------------------------------------------------------- #

#: (b) qwen3-8b (SERVE_LAYERS layers) behind both serving engines: 4
#: streams, 16 slots, 512 cache positions, pages of 16 tokens, 256 pages
#: (the sweep's U), a reconfiguration every 32 steps; 32 requests from
#: ``default_rng(0)`` (:func:`serve_requests`).
SERVE_STREAMS, SERVE_SLOTS, SERVE_MAX_LEN = 4, 16, 512
SERVE_PAGE_TOKENS, SERVE_PAGES, SERVE_INTERVAL = 16, 256, 32
SERVE_REQUESTS, SERVE_HOT_PREFIX = 32, 48
SERVE_MAX_STEPS = 10_000
#: (b)-(c) and phase 17(f) run qwen3-8b at full width cut to 8 of its 36
#: layers, as phases 16(c) and 18-20 do: the depth sets the engines' step
#: time, and with it most of the two phases' seconds.
SERVE_LAYERS = 8
#: slot_share is float32 in the device engine, float64 in the host one.
SERVE_SHARE_RTOL = 1e-6


def on_card() -> bool:
    return DEVICE == "cuda"


def serve_ref():
    """``tests/_torch_serving_ref.py`` (JAX-free at import): the reference
    test's fixtures, the margin recorder and the token rule."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_serving_ref

    return _torch_serving_ref


def serve_config():
    from repro_torch.serving import EngineConfig

    return EngineConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        page_tokens=SERVE_PAGE_TOKENS, total_pages=SERVE_PAGES,
        reconfig_every_steps=SERVE_INTERVAL)


def serve_requests(vocab: int):
    """32 requests, stream ``i % 4``: stream 0 a shared 48-token hot
    prefix and 16 tokens of its own, streams 1-3 unique prompts of 16-128
    tokens; 16-48 new tokens each.  Lengths come from one generator and
    tokens from another, so the schedule does not depend on ``vocab``
    (there is no end-of-sequence token: the schedule depends on lengths
    alone)."""
    import numpy as np
    from repro_torch.serving import Request

    rng, tok = np.random.default_rng(0), np.random.default_rng(1)
    hot = tok.integers(0, vocab, SERVE_HOT_PREFIX)
    reqs = []
    for i in range(SERVE_REQUESTS):
        stream = i % SERVE_STREAMS
        n = 16 if stream == 0 else int(rng.integers(16, 129))
        prompt = tok.integers(0, vocab, n)
        if stream == 0:
            prompt = np.concatenate([hot, prompt])
        reqs.append(Request(stream, prompt.astype(np.int32),
                            int(rng.integers(16, 49))))
    return reqs


def serve_model_config():
    """Phase 15(b)-(c)'s and 17(f)'s model: qwen3-8b at full width, cut
    to SERVE_LAYERS layers."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("qwen3-8b"),
                               n_layers=SERVE_LAYERS)


def serve_first_boundary():
    """The device engine's greedy inputs at its first reconfiguration, at
    phase 15(b)'s engine configuration and requests (B = 1, n = 4, U =
    256): they depend on the schedule alone, so the qwen3-8b smoke model
    (built on the CPU and moved) gives the full config's."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serving import GraphServingEngine

    cfg = configs.get_smoke("qwen3-8b")
    model = build(cfg, device="cpu", seed=0).to(DEVICE)
    GraphServingEngine(model, SERVE_STREAMS, serve_config(),
                       device=DEVICE).run(serve_requests(cfg.vocab_size))


def serve_schedule(eng, reqs) -> dict:
    """What both engines decide, token values aside."""
    import numpy as np

    return {"steps": eng.steps, "reconfigs": eng.reconfigs,
            "queue_wait": np.asarray(eng.queue_wait, np.float64),
            "slot_share": np.asarray(eng.slot_share, np.float64),
            "tokens_done": np.asarray(eng.tokens_done, np.float64),
            "lengths": [len(r.generated) for r in reqs]}


def serve_outputs(eng, reqs) -> dict:
    """Every output of a run: the schedule, tokens and, for the host
    engine, the pool; for the device engine, its coarse pool."""
    import dataclasses

    import numpy as np

    out = {**serve_schedule(eng, reqs), "tokens": [r.generated for r in reqs]}
    if hasattr(eng, "pool"):
        out.update(partition=eng.pool.partition.tolist(),
                   occupancy=eng.pool.occupancy().tolist(),
                   readahead=np.asarray(eng.readahead).tolist(),
                   stats=[dataclasses.astuple(s) for s in eng.pool.stats])
    else:
        out.update({k: np.asarray(getattr(eng, k)).tolist() for k in (
            "intervals", "partition", "occupancy", "readahead", "evictions",
            "demand_hits", "demand_misses", "prefetch_hits",
            "prefetch_misses", "idle_steps")})
    return out


def differing(a: dict, b: dict) -> list:
    """Keys whose values differ (arrays compared exactly)."""
    import numpy as np

    return [k for k in a if not (np.array_equal(a[k], b[k])
                                 if isinstance(a[k], np.ndarray)
                                 else a[k] == b[k])]


def counted(fn):
    """``fn()`` and the launches it added to each counter (nonzero)."""
    from repro_torch.core.dispatch import launch_counts

    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()
                 if v != before[k]}


def serve_smoke(card: str) -> dict:
    """(a) The reference test's fixtures with the qwen3-8b smoke model
    (float32, built on the CPU and moved): both engines on the card
    against the port's CPU run, every output exact; on the card the
    device engine's interval program replays once an interval and its
    reconfiguration program once a reconfiguration, launching the greedy
    then (plus once in the warm-up before its capture)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serving import (EngineConfig, GraphServingEngine,
                                     Request, ServingEngine)

    ref = serve_ref()
    cfg = configs.get_smoke("qwen3-8b")
    cpu = build(cfg, device="cpu", seed=0)
    card_model = copy.deepcopy(cpu).to(DEVICE)
    rows = {}
    for name, (n, ecfg, make, groups) in ref.fixtures(EngineConfig).items():
        engines = [("host", lambda m: ServingEngine(
            m, n, ecfg, device=m.device.type))] + [
            (f"graph{g}", lambda m, g=g: GraphServingEngine(
                m, n, ecfg, n_groups=g, device=m.device.type))
            for g in groups]
        for kind, make_engine in engines:
            outs = []
            for model in (cpu, card_model):
                eng, reqs = make_engine(model), make(Request, cfg.vocab_size)
                _, counts = counted(lambda: eng.run(reqs, max_steps=300))
                outs.append((serve_outputs(eng, reqs), counts))
            (want, _), (got, counts) = outs
            counts = {"serve_graph": 0, "serve_reconfig": 0,
                      "lookahead_greedy": 0, **counts}
            diff = differing(want, got)
            check(not diff, f"serve (a) {name} {kind}: card differs from "
                  f"the CPU in {diff}")
            if kind != "host":
                warmup = int("reconfigure_warmup" in eng.capture_seconds)
                check(counts["serve_graph"] == got["intervals"]
                      and counts["serve_reconfig"] == got["reconfigs"]
                      and counts["lookahead_greedy"]
                      == got["reconfigs"] + warmup,
                      f"serve (a) {name} {kind}: launches {counts} for "
                      f"{got['intervals']} intervals and {got['reconfigs']} "
                      "reconfigurations")
            rows[f"{name}/{kind}"] = {
                "steps": got["steps"], "reconfigs": got["reconfigs"],
                "launches": {k: v for k, v in counts.items() if v}}
    emit(card, phase="serve", case="smoke", equal_to_cpu=True, runs=rows)
    del card_model
    return rows


def serve_full(card: str) -> dict:
    """(b) and (c): qwen3-8b at full width (bf16) cut to SERVE_LAYERS
    layers behind the host engine once and the device engine cold, warm
    and for one profiled interval; then the device engine with CBP off."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.models import build
    from repro_torch.serving import GraphServingEngine, ServingEngine

    ref = serve_ref()
    cfg = serve_model_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, build_s = synced_wall(lambda: build(cfg, DEVICE, seed=0))
    ecfg = serve_config()

    def timed(eng, max_steps: int = SERVE_MAX_STEPS):
        reqs = serve_requests(cfg.vocab_size)
        (_, wall), counts = counted(lambda: synced_wall(
            lambda: eng.run(reqs, max_steps=max_steps)))
        return reqs, wall, {"serve_graph": 0, "serve_reconfig": 0,
                            "lookahead_greedy": 0, **counts}

    def rates(eng, reqs, wall) -> dict:
        gen = sum(len(r.generated) for r in reqs)
        return {"wall_s": wall, "steps": eng.steps,
                "ms_per_step": 1e3 * wall / eng.steps,
                "generated_tokens": gen,
                "generated_tokens_per_s": gen / wall,
                "decoded_tokens_per_s": float(np.sum(eng.tokens_done))
                / wall}

    host = ServingEngine(model, SERVE_STREAMS, ecfg, device=DEVICE)
    margins = ref.record_margins(host, ref.top2_torch)
    h_reqs, h_wall, h_counts = timed(host)
    want = serve_schedule(host, h_reqs)

    graph = GraphServingEngine(model, SERVE_STREAMS, ecfg, device=DEVICE)
    runs = {}
    for kind in ("cold", "warm"):
        reqs, wall, counts = timed(graph)
        got = serve_schedule(graph, reqs)
        shares = got.pop("slot_share")
        diff = differing(got, want)
        check(not diff and np.allclose(shares, want["slot_share"],
                                       rtol=SERVE_SHARE_RTOL, atol=0),
              f"serve (b) {kind}: schedule differs from the host engine "
              f"in {diff or ['slot_share']}")
        verdicts = [ref.token_rule(r.generated, h.generated,
                                   margins[h.rid])
                    for r, h in zip(reqs, h_reqs)]
        check("differ" not in verdicts,
              f"serve (b) {kind}: tokens differ from the host engine in "
              f"{verdicts.count('differ')} requests")
        warmup = int("reconfigure_warmup" in graph.capture_seconds)
        check(warmup == (kind == "cold" and on_card())
              and counts["serve_graph"] == graph.intervals
              and counts["serve_reconfig"] == graph.reconfigs
              and counts["lookahead_greedy"] == graph.reconfigs + warmup,
              f"serve (b) {kind}: launches {counts} for {graph.intervals} "
              f"intervals and {graph.reconfigs} reconfigurations")
        part = graph.partition.reshape(-1, SERVE_STREAMS)
        check(bool((part.sum(-1) == SERVE_PAGES).all()
                   and (part >= 2).all()),
              f"serve (b) {kind}: partition {graph.partition}")
        runs[kind] = {**rates(graph, reqs, wall),
                      "intervals": graph.intervals,
                      "reconfigs": graph.reconfigs,
                      "idle_steps": graph.idle_steps,
                      "excused_requests": verdicts.count("excused"),
                      "launches": {k: v for k, v in counts.items() if v},
                      "partition": graph.partition.tolist(),
                      "capture_seconds": graph.capture_seconds}
    # one warm interval: unprofiled, then under the profiler
    _, one_wall, _ = timed(graph, max_steps=SERVE_INTERVAL)
    prof = device_profile(lambda: graph.run(serve_requests(cfg.vocab_size),
                                            max_steps=SERVE_INTERVAL))
    prof["interval_wall_s"] = one_wall
    prof["busy_share"] = (prof["device_s"] / one_wall
                          if prof["device_s"] else None)
    peak = torch.cuda.max_memory_allocated()

    off = GraphServingEngine(
        model, SERVE_STREAMS,
        dataclasses.replace(ecfg, reconfig_every_steps=10 ** 9),
        device=DEVICE)
    o_reqs, o_wall, o_counts = timed(off)
    check(off.reconfigs == 0 and o_counts["lookahead_greedy"] == 0
          and o_counts["serve_reconfig"] == 0
          and o_counts["serve_graph"] == off.intervals
          and all(len(r.generated) == r.max_new_tokens for r in o_reqs),
          f"serve (c) CBP off: reconfigs {off.reconfigs}, launches "
          f"{o_counts}")
    same_tokens = sum(r.generated == h.generated
                      for r, h in zip(o_reqs, h_reqs))
    out = {"config": cfg.name, "param_dtype": cfg.param_dtype,
           "n_layers": cfg.n_layers, "weight_bytes": weight_bytes(model),
           "build_s": build_s, "engine": dataclasses.asdict(ecfg),
           "streams": SERVE_STREAMS, "requests": len(h_reqs),
           "prompt_tokens": int(sum(len(r.prompt) for r in h_reqs)),
           "host": {**rates(host, h_reqs, h_wall),
                    "reconfigs": host.reconfigs,
                    "launches": {k: v for k, v in h_counts.items() if v}},
           "graph": runs, "interval_profile": prof, "peak_bytes": peak,
           "cbp_off": {**rates(off, o_reqs, o_wall),
                       "intervals": off.intervals,
                       "idle_steps": off.idle_steps,
                       "capture_seconds": off.capture_seconds,
                       "launches": {k: v for k, v in o_counts.items() if v},
                       "requests_with_cbp_on_tokens": same_tokens}}
    emit(card, phase="serve", case="qwen3-8b_full", **out)
    # What dropping the engines, then the model, frees with the collector
    # off: memory a reference cycle holds stays allocated.
    enabled = gc.isenabled()
    gc.disable()
    try:
        sync()
        before = torch.cuda.memory_allocated()
        del host, graph, off
        engines = torch.cuda.memory_allocated()
        del model
        dropped = torch.cuda.memory_allocated()
    finally:
        if enabled:
            gc.enable()
    emit(card, phase="serve", case="drop", collector="off",
         allocated_before_bytes=before,
         after_dropping_engines_bytes=engines,
         after_dropping_model_bytes=dropped)
    out["drop"] = {"before": before, "engines": engines, "model": dropped}
    torch.cuda.empty_cache()
    return out


def serve_phase(card: str) -> dict:
    """Phase 15, with the launch counts reset just before it and read just
    after; returns them."""
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()
    serve_smoke(card)
    full = serve_full(card)
    counts = launch_counts()
    check(counts["lookahead_greedy"] > 0, "serve: the greedy never launched")
    emit(card, phase="serve", case="summary",
         seconds=time.perf_counter() - t0, launches=counts,
         host_ms_per_step=full["host"]["ms_per_step"],
         graph_warm_ms_per_step=full["graph"]["warm"]["ms_per_step"],
         capture_seconds=full["graph"]["cold"]["capture_seconds"],
         busy_share=full["interval_profile"]["busy_share"],
         peak_bytes=full["peak_bytes"])
    return counts


# --------------------------------------------------------------------- #
# phase 16: the training path
# --------------------------------------------------------------------- #

#: (a) Every smoke config, 3 AdamW steps at lr 1e-3 on 2 x 32 tokens,
#: from parameters built on the CPU and copied to the card (float32, TF32
#: off), against the port's CPU run: losses within atol 1e-5 max(1,
#: |loss|) + rtol 1e-4 (the CPU gradient gate's bound); parameters within
#: that bound on at least 99.9 % of entries and every entry within
#: 2 lr steps (AdamW's first step is nearly a sign function, so an entry
#: whose gradient's sign is decided by rounding moves by up to 2 lr; MoE
#: gradients on the card sum by atomics, so are not bit-reproducible).
#: zamba2-7b (R4) also within 4 times the CPU run's own spread, its
#: parameters one ulp up.
TRAIN_SMOKE_STEPS, TRAIN_SMOKE_LR = 3, 1e-3
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 32
TRAIN_ATOL, TRAIN_RTOL, TRAIN_SHARE = 1e-5, 1e-4, 0.999
#: (c) qwen3-8b at full width (bf16, remat "full"), depth cut to 8 of its
#: 36 layers: 6 AdamW steps at lr 3e-4, then 3 Adafactor steps, on
#: SyntheticTokens batches of 4 x 1,024 through the PrefetchPipeline.
TRAIN_FULL_LAYERS, TRAIN_FULL_B, TRAIN_FULL_S = 8, 4, 1024
TRAIN_FULL_ADAMW, TRAIN_FULL_ADAFACTOR, TRAIN_FULL_LR = 6, 3, 3e-4
#: Steps of (c) run again with each layer taken by a per-layer select
#: (``t[i]``) instead of one ``unbind``: the stacked-gradient writes.
TRAIN_SELECT_STEPS = 2
#: Peak device memory of (c)'s AdamW run above what was allocated when
#: (c) began (what earlier phases left resident): PERF.md's prediction
#: for the run, written before the first chip call of PR 25 (47-56 GB
#: expected).
TRAIN_PEAK_LIMIT = 60e9
#: Device time of (c)'s profiled AdamW step by kernel name: products
#: (cuBLAS), casts, copies and fills, reductions, index and scatter work,
#: softmax, and the rest (elementwise arithmetic).
TRAIN_KERNEL_CATEGORIES = {
    "gemm": ("nvjet", "gemm", "cutlass", "xmma"),
    "copy_cast_fill": ("copy", "Memcpy", "Memset", "fill"),
    "reduction": ("reduce",),
    "index_scatter_sort": ("index", "scatter", "gather", "sort", "radix"),
    "softmax": ("softmax",),
}
#: (d) tests/test_train_loop.py:34's plant and coordinator run.
BINDING_UNITS, BINDING_BW, BINDING_MS = 64, 100.0, 100.0


def train_inputs(cfg, step: int, device) -> dict:
    """Step ``step``'s smoke batch (:func:`model_inputs`, seed ``step``)."""
    return model_inputs(cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S, device,
                        seed=step)


def train_run(model, device) -> tuple:
    """TRAIN_SMOKE_STEPS AdamW steps: (losses, final parameters on the
    CPU by name)."""
    import torch
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import TrainStepConfig, build_train_step

    init_opt, step = build_train_step(
        model, TrainStepConfig(lr=TRAIN_SMOKE_LR))
    params = model.params
    opt = init_opt(params)
    losses = []
    for i in range(TRAIN_SMOKE_STEPS):
        params, opt, metrics = step(params, opt,
                                    train_inputs(model.cfg, i, device))
        losses.append(float(metrics["loss"]))
    return (torch.tensor(losses, dtype=torch.float64),
            [p.detach().float().cpu() for p in tree_leaves(params)])


def train_outside(got, want, spread: float, what: str) -> tuple:
    """(entries past the bound, largest |diff|); checks 2 lr steps."""
    diff = (got - want).abs()
    limit = 2 * TRAIN_SMOKE_LR * TRAIN_SMOKE_STEPS
    check(float(diff.max()) <= limit,
          f"train {what}: card vs CPU {float(diff.max()):.3g} past "
          f"2 lr steps = {limit:.3g}")
    atol = max(TRAIN_ATOL * max(1.0, float(want.abs().max())),
               R4_FACTOR * spread)
    return int((diff > atol + TRAIN_RTOL * want.abs()).sum()), \
        float(diff.max())


def train_smoke(card: str) -> dict:
    """(a) Every smoke config trained on the card against the CPU."""
    import copy

    from repro_torch import configs
    from repro_torch.models import build

    out = {}
    for name in configs.names():
        cfg = configs.get_smoke(name)
        cpu = build(cfg, device="cpu", seed=0)
        card_model = copy.deepcopy(cpu).to(DEVICE)
        spread_loss, spread_params = 0.0, None
        if name == "zamba2-7b":
            l1, p1 = train_run(nudged(cpu), "cpu")
        want_l, want_p = train_run(cpu, "cpu")
        if name == "zamba2-7b":
            spread_loss = float((l1 - want_l).abs().max())
            spread_params = [float((a - b).abs().max())
                             for a, b in zip(p1, want_p)]
        got_l, got_p = train_run(card_model, DEVICE)
        check(bool(got_l.isfinite().all()), f"train {name}: loss not finite")
        loss_err = float((got_l - want_l).abs().max())
        loss_atol = max(TRAIN_ATOL * max(1.0, float(want_l.abs().max())),
                        R4_FACTOR * spread_loss)
        check(bool(((got_l - want_l).abs()
                    <= loss_atol + TRAIN_RTOL * want_l.abs()).all()),
              f"train {name}: card losses {got_l.tolist()} vs CPU "
              f"{want_l.tolist()}")
        outside, worst, total = 0, 0.0, 0
        for i, (g, w) in enumerate(zip(got_p, want_p)):
            n, d = train_outside(g, w, spread_params[i] if spread_params
                                 else 0.0, f"{name} leaf {i}")
            outside, worst, total = outside + n, max(worst, d), \
                total + w.numel()
        check(outside <= (1 - TRAIN_SHARE) * total,
              f"train {name}: {outside} of {total} parameter entries past "
              f"the bound")
        out[name] = {"loss_max_abs": loss_err, "param_max_abs": worst,
                     "entries_outside": outside, "entries": total}
        emit(card, phase="train", case="smoke", config=name,
             losses_card=got_l.tolist(), losses_cpu=want_l.tolist(),
             **out[name], cpu_one_ulp_loss_spread=spread_loss)
        del card_model
    return out


def train_loop_checks(card: str) -> dict:
    """(b) The loop on the card: the loss decreases; a restart re-runs
    only the missing steps; bf16 parameters and the f32 optimizer state
    come back from a checkpoint bit for bit, on the card."""
    import dataclasses
    import pathlib
    import tempfile

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import _msgpack
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build
    from repro_torch.train import TrainStepConfig, build_train_step

    rec = {}
    t0 = time.perf_counter()
    out = train_loop("qwen3-8b", steps=30, batch=4, seq=32, log_every=0,
                     cbp_manage=False, device=DEVICE)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    check(last < first, f"train loop: loss did not fall ({first}, {last})")
    rec["qwen3_8b_loss_first5_last5"] = [float(first), float(last)]
    rec["qwen3_8b_30_steps_s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(batch=2, seq=32, ckpt_dir=pathlib.Path(tmp) / "ckpt",
                  ckpt_every=5, log_every=0, cbp_manage=False, device=DEVICE)
        train_loop("mamba2-1.3b", steps=10, **kw)
        out2 = train_loop("mamba2-1.3b", steps=16, **kw)
        check(len(out2["losses"]) == 6 and np.isfinite(out2["final_loss"]),
              f"train restart: {out2['losses']}")
        rec["restart_losses"] = out2["losses"]

        cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"),
                                  param_dtype="bfloat16")
        model = build(cfg, DEVICE, seed=0)
        init_opt, step = build_train_step(model, TrainStepConfig())
        params = model.params
        opt = init_opt(params)
        for i in range(2):
            params, opt, _ = step(params, opt, train_inputs(cfg, i, DEVICE))
        tree = {"params": params, "opt": opt}
        mgr = CheckpointManager(pathlib.Path(tmp) / "bf16", keep=2)
        mgr.save(2, tree, extra={"data": {"index": 2}})
        leaves = ckpt_mod._leaves(tree)
        like = ckpt_mod._rebuild(tree, {ckpt_mod._name(p): torch.zeros_like(t)
                                        for p, t in leaves})
        step_no, got, _ = mgr.restore_latest(like)
        manifest = _msgpack.unpackb(
            (pathlib.Path(tmp) / "bf16" / "step_0000000002"
             / "manifest.msgpack").read_bytes())["leaves"]
        for (path, want), (_, g) in zip(leaves, ckpt_mod._leaves(got)):
            what = ckpt_mod._name(path)
            check(g.dtype == want.dtype and g.device == want.device
                  and torch.equal(g, want),
                  f"train bf16 checkpoint: {what} differs")
        check(manifest["params/embed"]["dtype"] == "bfloat16"
              and manifest["opt/.master/embed"]["dtype"] == "float32",
              "train bf16 checkpoint: manifest dtypes")
        rec["bf16_checkpoint_leaves"] = len(leaves)
    emit(card, phase="train", case="loop", **rec)
    return rec


def train_full(card: str) -> dict:
    """(c) qwen3-8b at full width, cut to TRAIN_FULL_LAYERS layers: AdamW
    then Adafactor steps through ``build_train_step`` and the
    ``PrefetchPipeline``; step times, tokens/s, model FLOP share, the
    optimizer's share, the card's busy share and peak memory."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch import configs
    from repro_torch.data import PrefetchPipeline, SyntheticTokens
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.optim import make_optimizer
    from repro_torch.models.layers import tree_map
    from repro_torch.train import TrainStepConfig, build_train_step

    cfg = dataclasses.replace(configs.get("qwen3-8b"),
                              n_layers=TRAIN_FULL_LAYERS)
    tokens = TRAIN_FULL_B * TRAIN_FULL_S
    n_params = cfg.param_count()
    n_embed = cfg.vocab_size * cfg.d_model
    n_matmul = n_params - n_embed - cfg.d_model   # layers + head
    n_layers = n_matmul - cfg.d_model * cfg.vocab_size
    out = {"config": f"qwen3-8b, {TRAIN_FULL_LAYERS} of 36 layers",
           "params": n_params, "tokens_per_step": tokens,
           "remat": cfg.remat, "dtype": cfg.param_dtype}
    # what earlier phases dropped but a reference cycle still holds
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    out["resident_bytes"] = resident
    model = build(cfg, DEVICE, seed=0)
    pipe = PrefetchPipeline(SyntheticTokens(
        TRAIN_FULL_B, TRAIN_FULL_S, cfg.vocab_size, seed=1), depth=2)

    def run(kind: str, steps: int) -> dict:
        init_opt, step = build_train_step(
            model, TrainStepConfig(optimizer=kind, lr=TRAIN_FULL_LR))
        params = model.params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt = init_opt(params)
        losses, walls = [], []
        for _ in range(steps):
            batch = next(pipe)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))   # waits for the step
            walls.append(time.perf_counter() - t0)
        check(all(math.isfinite(v) for v in losses),
              f"train full {kind}: losses {losses}")
        warm = statistics.median(walls[1:])
        peak = torch.cuda.max_memory_allocated()
        rec = {"losses": losses, "step_s": walls, "warm_step_s": warm,
               "tokens_per_s": tokens / warm, "peak_bytes": peak,
               "run_peak_bytes": peak - resident,
               "model_flop_share_6n": 6 * n_params * tokens / warm
               / BF16_TC_OPS_PER_S,
               "with_remat_recompute_share": (6 * n_params + 2 * n_layers)
               * tokens / warm / BF16_TC_OPS_PER_S}
        return rec, step, params, opt

    adamw, step, params, opt = run("adamw", TRAIN_FULL_ADAMW)
    check(adamw["run_peak_bytes"] <= TRAIN_PEAK_LIMIT,
          f"train full: the run's peak {adamw['run_peak_bytes'] / 1e9:.2f} "
          f"GB (above {resident / 1e9:.2f} GB resident) past the "
          f"prediction's {TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    prof = device_profile(lambda: step(params, opt, next(pipe)),
                          categories=TRAIN_KERNEL_CATEGORIES)
    if prof["device_s"] is not None:
        adamw["busy_share"] = prof["device_s"] / adamw["warm_step_s"]
    adamw["device_s"] = prof["device_s"]
    adamw["category_device_s"] = prof["category_device_s"]
    adamw["kernels_per_step"] = prof["device_events"]

    # the optimizer alone: the update on gradients of the parameters'
    # shape and dtype (the values do not change its work)
    _, update = make_optimizer("adamw", TRAIN_FULL_LR, weight_decay=0.1,
                               grad_clip=1.0)
    grads = tree_map(lambda p: p.detach() * 1e-3, params)
    walls = []
    for _ in range(3):
        (params, opt), wall = synced_wall(lambda: update(params, grads, opt))
        walls.append(wall)
    adamw["optimizer_s"] = statistics.median(walls[1:])
    adamw["optimizer_share"] = adamw["optimizer_s"] / adamw["warm_step_s"]
    del grads

    # the same step with each layer taken by a per-layer select
    layers = L.layers
    L.layers = lambda stack, n: [L.layer(stack, i) for i in range(n)]
    try:
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(TRAIN_SELECT_STEPS):
            (params, opt, _), wall = synced_wall(
                lambda: step(params, opt, next(pipe)))
            walls.append(wall)
        adamw["select_step_s"] = walls
        adamw["select_run_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                          - resident)
    finally:
        L.layers = layers
    del opt, step
    out["adamw"] = adamw
    emit(card, phase="train", case="qwen3-8b_full_adamw",
         **adamw, top_device_s=prof["top_device_s"])
    torch.cuda.empty_cache()

    adafactor, step, params, opt = run("adafactor", TRAIN_FULL_ADAFACTOR)
    del opt, step
    out["adafactor"] = adafactor
    emit(card, phase="train", case="qwen3-8b_full_adafactor", **adafactor)
    pipe.stop()
    del model, params
    torch.cuda.empty_cache()
    return out


def train_binding(card: str) -> dict:
    """(d) tests/test_train_loop.py:34 on the card: the port's
    ``CBPCoordinator`` over a ``TrainingPlant`` converges as the test
    asserts, and the greedy launches once per reconfiguration."""
    import numpy as np
    from repro_torch.core.coordinator import CBPCoordinator
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.core.types import CBPParams, fig8_schedule
    from repro_torch.runtime.cbp_runtime import TrainingPlant

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_train_ref import training_plant_step_fn

    params = CBPParams(min_bandwidth_allocation=5.0, min_ways=2)
    plant = TrainingPlant(2, BINDING_UNITS, BINDING_BW,
                          training_plant_step_fn(BINDING_UNITS, BINDING_BW),
                          device=DEVICE)
    coord = CBPCoordinator(plant, params=params)
    reset_launch_counts()
    t0 = time.perf_counter()
    coord.run(BINDING_MS)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    alloc = coord.alloc
    units = alloc.cache_units.cpu().numpy()
    bw = alloc.bandwidth.cpu().numpy()
    check(units[0] > units[1] and bw[1] > bw[0]
          and bool(alloc.prefetch_on[0]) and int(units.sum()) == BINDING_UNITS
          and np.isclose(bw.sum(), BINDING_BW),
          f"train binding: {units}, {bw}, {alloc.prefetch_on}")
    reconfigs = sum(seg.kind == "reconfigure"
                    for seg in fig8_schedule(BINDING_MS, params, True))
    if on_card():
        check(counts["lookahead_greedy"] == reconfigs,
              f"train binding: {counts['lookahead_greedy']} greedy launches "
              f"for {reconfigs} reconfigurations")
    rec = {"wall_s": wall, "reconfigurations": reconfigs,
           "greedy_launches": counts["lookahead_greedy"],
           "cache_units": units.tolist(), "bandwidth": bw.tolist()}
    emit(card, phase="train", case="binding", **rec)
    return rec


def train_phase(card: str) -> tuple:
    """Phase 16, with the launch counts reset just before (a)-(c) and read
    just after (the training path launches no hand-written kernel: the
    reference's training step reaches none), then reset again for (d),
    the coordinator binding, whose greedy launches are printed apart."""
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    reset_launch_counts()
    smoke = train_smoke(card)
    loop = train_loop_checks(card)
    full = train_full(card)
    counts = launch_counts()
    check(not any(counts.values()),
          f"train: a hand-written kernel launched: {counts}")
    binding = train_binding(card)
    emit(card, phase="train", case="summary",
         seconds=time.perf_counter() - t0, launches=counts,
         smoke_configs=len(smoke), loop=loop,
         adamw_warm_step_s=full["adamw"]["warm_step_s"],
         adamw_tokens_per_s=full["adamw"]["tokens_per_s"],
         adamw_run_peak_bytes=full["adamw"]["run_peak_bytes"],
         resident_bytes=full["resident_bytes"],
         adafactor_warm_step_s=full["adafactor"]["warm_step_s"],
         binding_greedy_launches=binding["greedy_launches"])
    return counts, binding


# --------------------------------------------------------------------- #
# phase 17: the sweep's and the static search's shards
# --------------------------------------------------------------------- #

#: Shards forced on the one card (``use_devices([cuda:0] * N)``): the full
#: sweep and Fig. 5's study on 2, the 32-mix sweep and one
#: ``run_timeline`` on 3 (a prime count, so the blocks are uneven; each
#: block pays the host dispatch of every slot, so the wall grows with the
#: count).  Discrete outputs exactly equal the unsharded run's, floats
#: within SHARD_RTOL.
SHARD_FULL, SHARD_SMALL = 2, 3
SHARD_RTOL = 1e-12
#: ``run_timeline``'s timeline (the reference tests' 20 ms): each block
#: pays the host dispatch of every slot, ~2 s at 100 ms.
SHARD_TIMELINE_MS = 20.0


def shard_diff(pairs, what: str) -> dict:
    """Hold each (label, sharded, unsharded) of ``pairs``: integer and
    boolean arrays equal, floats finite and within SHARD_RTOL.  Returns
    the largest absolute and relative float differences."""
    import numpy as np

    worst = {"max_abs_diff": 0.0, "max_rel_diff": 0.0}
    for label, x, y in pairs:
        x, y = np.asarray(x), np.asarray(y)
        check(x.shape == y.shape, f"{what}: {label} shape {x.shape} != "
              f"{y.shape}")
        if x.dtype.kind in "biu":
            check(np.array_equal(x, y), f"{what}: {label} differs")
            continue
        check(np.isfinite(x).all() and np.allclose(
            x, y, rtol=SHARD_RTOL, atol=0.0),
            f"{what}: {label} beyond rtol {SHARD_RTOL}")
        diff = np.abs(x - y)
        worst["max_abs_diff"] = max(worst["max_abs_diff"],
                                    float(diff.max(initial=0.0)))
        worst["max_rel_diff"] = max(worst["max_rel_diff"], float(
            (diff / np.where(y == 0, 1.0, np.abs(y))).max(initial=0.0)))
    return worst


def sweep_pairs(got, want):
    pairs = [("baseline", got.baseline_ipc, want.baseline_ipc)]
    for name in want.manager_names:
        a, b = got.final_alloc[name], want.final_alloc[name]
        pairs += [(f"{name} ipc", got.ipc[name], want.ipc[name]),
                  (f"{name} cache_units", a.cache_units, b.cache_units),
                  (f"{name} bandwidth", a.bandwidth, b.bandwidth),
                  (f"{name} prefetch_on", a.prefetch_on, b.prefetch_on)]
    return pairs


#: (e) The reference's sharded-engine fixture (``tests/test_serving_jax.
#: py``'s ``_PARITY_SCRIPT``: 40 requests, seed 7, 16 slots, 64 pages of
#: 4 tokens, a reconfiguration every 8 steps) with the qwen3-8b smoke
#: model (float32, built on the CPU and moved), one group a stream:
#: name -> (streams = groups, forced blocks, forced grid or None).  The
#: reference's plan never splits a block's groups (it always has K = a or
#: b = 1), so the last case forces a (4, 4, 2, 2) grid: block 0 holds
#: groups 0, 1, 4 and 5.
SHARD_SERVE_CASES = {
    "parity_8_on_8": (8, 8, None),
    "parity_16_on_4": (16, 4, None),
    "parity_16_on_4_grid_4x4": (16, 4, (4, 4, 2, 2)),
}
#: (f) phase 15(b)'s model at its engine configuration,
#: 2 groups on 2 forced blocks against the unsharded 2-group engine; the
#: first 16 of phase 15(b)'s 32 requests.
SHARD_FULL_GROUPS, SHARD_FULL_REQUESTS = 2, 16
#: Decode steps of the batch-split logit comparison.
SHARD_LOGIT_STEPS = 4
#: Discrete outputs of the device engine, held exactly.
SERVE_DISCRETE = ("steps", "reconfigs", "intervals", "partition",
                  "readahead", "occupancy", "evictions", "tokens_done",
                  "demand_hits", "demand_misses", "prefetch_hits",
                  "prefetch_misses")


def block_devices(n: int) -> list:
    """``n`` blocks forced onto the one card (or the CPU, rehearsing)."""
    import torch

    return [torch.device(DEVICE, 0) if on_card() else torch.device(DEVICE)
            ] * n


def graph_run(model, n_streams, n_groups, ecfg, reqs, devices, grid=None,
              max_steps=SERVE_MAX_STEPS):
    """A ``GraphServingEngine`` planned over ``devices`` (``grid`` forces
    its plan) runs ``reqs``; the engine, its host wall (captures
    included) and the peak memory of the run (None off the card)."""
    from unittest import mock

    import torch
    from repro_torch import distributed
    from repro_torch.serving import GraphServingEngine, engine_graph

    plan = (mock.patch.object(engine_graph, "_plan_grid",
                              lambda *_: grid) if grid
            else contextlib.nullcontext())
    with distributed.use_devices(devices), plan:
        eng = GraphServingEngine(model, n_streams, ecfg, n_groups=n_groups,
                                 device=model.device.type)
    if on_card():
        torch.cuda.reset_peak_memory_stats()
    _, wall = synced_wall(lambda: eng.run(reqs, max_steps=max_steps))
    peak = torch.cuda.max_memory_allocated() if on_card() else None
    return eng, wall, peak


def shard_outputs(eng, reqs) -> dict:
    """What a sharded serving run is held to: tokens, the discrete
    outputs and the float32 shares and waits."""
    import numpy as np

    return {"tokens": [r.generated for r in reqs],
            "rids": [r.rid for r in reqs],
            **{k: np.asarray(getattr(eng, k)) for k in SERVE_DISCRETE + (
                "slot_share", "queue_wait")}}


def serve_shard_gate(got: dict, want: dict, margins, what: str) -> dict:
    """Hold a sharded run's outputs (:func:`shard_outputs`) to another
    run's: every request's tokens equal, or excused by the token rule on
    the host engine's margins (``margins()``, run only when some request
    differs); the discrete outputs exactly equal (the schedule depends on
    lengths alone, so it holds where tokens are excused too);
    ``slot_share`` and ``queue_wait`` within SERVE_SHARE_RTOL.  Returns
    the counts of differing and excused requests and the largest share
    and wait distances."""
    import numpy as np

    ref = serve_ref()
    differ = [a != b for a, b in zip(got["tokens"], want["tokens"])]
    excused = 0
    if any(differ):
        m = margins()
        verdicts = [ref.token_rule(a, b, m.get(rid, [])) for a, b, rid in
                    zip(got["tokens"], want["tokens"], want["rids"])]
        check("differ" not in verdicts,
              f"{what}: tokens differ in {verdicts.count('differ')} "
              "requests")
        excused = verdicts.count("excused")
    for key in SERVE_DISCRETE:
        check(np.array_equal(got[key], want[key]), f"{what}: {key} differs")
    worst = {}
    for key in ("slot_share", "queue_wait"):
        check(np.allclose(got[key], want[key], rtol=SERVE_SHARE_RTOL,
                          atol=0),
              f"{what}: {key} beyond rtol {SERVE_SHARE_RTOL}")
        worst[f"{key}_max_abs_diff"] = float(
            np.abs(got[key] - want[key]).max(initial=0))
    return {"requests_differing": sum(differ), "excused": excused, **worst}


def host_margins(model, n_streams, ecfg, make):
    """The host engine's margins on ``make()``'s requests, as a thunk."""
    from repro_torch.serving import ServingEngine

    def run():
        ref = serve_ref()
        host = ServingEngine(model, n_streams, ecfg,
                             device=model.device.type)
        margins = ref.record_margins(host, ref.top2_torch)
        host.run(make(), max_steps=SERVE_MAX_STEPS)
        return margins

    return run


def split_logit_diff(model, batch: int, blocks: int, seed: int = 0
                     ) -> float:
    """The largest logit difference between one decode of ``batch`` rows
    and the same rows decoded in ``blocks`` blocks (the batch a sharded
    engine's block decodes), over SHARD_LOGIT_STEPS steps from empty
    caches, on the model's device: the rounding a smaller batch may bring
    (another GEMM kernel)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    dev = model.device
    whole = model.init_cache(batch, SHARD_LOGIT_STEPS, dtype=torch.float32)
    part = batch // blocks
    parts = [model.init_cache(part, SHARD_LOGIT_STEPS, dtype=torch.float32)
             for _ in range(blocks)]
    worst = 0.0
    for step in range(SHARD_LOGIT_STEPS):
        tokens = torch.randint(0, model.cfg.vocab_size, (batch, 1),
                               generator=gen).to(dev)
        pos = torch.full((batch,), step, dtype=torch.int32, device=dev)
        full, _ = model.decode_step(whole, tokens, pos, inplace=True)
        split = torch.cat([model.decode_step(
            parts[i], tokens[i * part:(i + 1) * part],
            pos[i * part:(i + 1) * part], inplace=True)[0]
            for i in range(blocks)])
        check(bool(torch.isfinite(full).all()), "split logits: not finite")
        worst = max(worst, float((full.float() - split.float()).abs().max()))
    return worst


def serve_shards(card: str) -> dict:
    """Phase 17 (e) and (f): the serving engine's groups sharded over
    forced blocks on the one card.  Each sharded run's references run
    first (the unsharded card run, and for (e) the port's CPU sharded
    run); the launch counts are reset just before each sharded run and
    read just after; returns their sums."""
    import copy

    import torch
    from repro_torch import configs
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.models import build
    from repro_torch.serving import EngineConfig, Request

    ref = serve_ref()
    total: dict = {}

    def sharded(fn):
        sync()
        reset_launch_counts()
        out = fn()
        sync()
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, counts

    def launch_rule(eng, counts, what):
        warmups = sum(k.endswith("reconfigure_warmup")
                      for k in eng.capture_seconds)
        blocks = len(eng.block_groups)
        check(counts["serve_graph"] == eng.intervals * blocks
              and counts["serve_reconfig"] == sum(eng.block_reconfigs)
              and counts["lookahead_greedy"]
              == sum(eng.block_reconfigs) + warmups,
              f"{what}: launches {counts} for {eng.intervals} intervals on "
              f"{blocks} blocks, block reconfigurations "
              f"{eng.block_reconfigs}, {warmups} warm-ups")

    # (e) the reference's fixture, smoke model
    cfg = configs.get_smoke("qwen3-8b")
    cpu = build(cfg, device="cpu", seed=0)
    card_model = copy.deepcopy(cpu).to(DEVICE)
    ecfg = ref.parity_config(EngineConfig)
    for name, (n, blocks, grid) in SHARD_SERVE_CASES.items():
        def make(n=n):
            return ref.parity_requests(Request, cfg.vocab_size, n)

        reqs = make()
        want = shard_outputs(graph_run(card_model, n, n, ecfg, reqs,
                                       block_devices(1), max_steps=300)[0],
                             reqs)
        reqs = make()
        on_cpu = shard_outputs(graph_run(
            cpu, n, n, ecfg, reqs, [torch.device("cpu")] * blocks, grid,
            max_steps=300)[0], reqs)
        reqs = make()
        (eng, wall, _), counts = sharded(lambda: graph_run(
            card_model, n, n, ecfg, reqs, block_devices(blocks), grid,
            max_steps=300))
        check(len(eng.block_groups) == blocks
              and (grid is None or eng.block_groups[0] == [0, 1, 4, 5]),
              f"shard serve {name}: blocks {eng.block_groups}")
        launch_rule(eng, counts, f"shard serve {name}")
        got = shard_outputs(eng, reqs)
        margins = host_margins(card_model, n, ecfg, make)
        emit(card, phase="shard", case=f"serve_{name}", blocks=blocks,
             grid=list(eng.grid), block_groups=eng.block_groups,
             wall_s=wall, steps=eng.steps, reconfigs=eng.reconfigs,
             block_reconfigs=eng.block_reconfigs,
             idle_steps=eng.idle_steps,
             launches={k: v for k, v in counts.items() if v},
             vs_unsharded=serve_shard_gate(
                 got, want, margins, f"shard serve {name} vs unsharded"),
             vs_cpu_sharded=serve_shard_gate(
                 got, on_cpu, margins, f"shard serve {name} vs the CPU"),
             split_logit_max_abs_diff=split_logit_diff(
                 card_model, ecfg.batch_slots, blocks))
        del eng
    del card_model, cpu

    # (f) qwen3-8b at full width, SERVE_LAYERS layers, 2 groups on 2 blocks
    full_cfg = serve_model_config()
    if on_card():
        torch.cuda.empty_cache()
    model = build(full_cfg, DEVICE, seed=0)
    ecfg = serve_config()

    def make_full():
        return serve_requests(full_cfg.vocab_size)[:SHARD_FULL_REQUESTS]

    def rates(eng, reqs, wall, peak) -> dict:
        capture = sum(eng.capture_seconds.values())
        gen = sum(len(r.generated) for r in reqs)
        return {"grid": list(eng.grid), "devices": [str(d) for d in
                                                      eng.devices],
                "wall_s": wall, "capture_s": capture, "steps": eng.steps,
                "ms_per_step": 1e3 * (wall - capture) / eng.steps,
                "generated_tokens_per_s": gen / (wall - capture),
                "capture_seconds": eng.capture_seconds,
                "block_reconfigs": eng.block_reconfigs,
                "idle_steps": eng.idle_steps, "peak_bytes": peak}

    sync()
    reqs = make_full()
    eng, wall, w_peak = graph_run(model, SERVE_STREAMS, SHARD_FULL_GROUPS,
                                  ecfg, reqs, block_devices(1))
    unsharded = rates(eng, reqs, wall, w_peak)
    want = shard_outputs(eng, reqs)
    del eng
    reqs = make_full()
    (eng, wall, peak), counts = sharded(lambda: graph_run(
        model, SERVE_STREAMS, SHARD_FULL_GROUPS, ecfg, reqs,
        block_devices(SHARD_FULL_GROUPS)))
    check(len(eng.block_groups) == SHARD_FULL_GROUPS,
          f"shard serve full: blocks {eng.block_groups}")
    launch_rule(eng, counts, "shard serve full")
    out = {"config": full_cfg.name, "n_layers": full_cfg.n_layers,
           "requests": len(reqs),
           "weight_bytes": weight_bytes(model),
           "unsharded": unsharded,
           "sharded": {**rates(eng, reqs, wall, peak),
                       "launches": {k: v for k, v in counts.items() if v}},
           "vs_unsharded": serve_shard_gate(
               shard_outputs(eng, reqs), want,
               host_margins(model, SERVE_STREAMS, ecfg, make_full),
               "shard serve full vs unsharded")}
    del eng
    out["split_logit_max_abs_diff"] = split_logit_diff(
        model, SERVE_SLOTS, SHARD_FULL_GROUPS)
    s_peak = out["sharded"]["peak_bytes"]
    check(not on_card() or s_peak < w_peak + out["weight_bytes"] / 2,
          f"shard serve full: peak {s_peak} against {w_peak} unsharded: "
          "the blocks do not share the weights")
    emit(card, phase="shard", case="serve_qwen3-8b_full", **out)
    del model
    sync()
    if on_card():
        torch.cuda.empty_cache()
    return total


def sharding_phase(card: str) -> dict:
    """Phase 17: the (manager, mix) grid of ``run_sweep`` and the workload
    axis of ``search_static`` sharded over ``use_devices([card] * N)``,
    each against its unsharded run on the card (run first, outside the
    count): the 4096-mix sweep and ``fig5_potential`` on 2 shards, the
    32-mix sweep and one ``run_timeline`` (CBP over the 32 mixes, 20 ms)
    on 3; then the serving engine's groups (:func:`serve_shards`).
    The launch counts are reset just before the sharded runs and read
    just after; returns their sums."""
    import torch
    from repro_torch import distributed
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.core.types import CBPParams
    from repro_torch.sim import (random_mixes, random_workloads, run_sweep,
                                 search_static, timeline)
    from repro_torch.sim.sweep import BatchedCMPPlant, _manager_spec

    t0 = time.perf_counter()
    study = load_static_golden()["study"][0]
    full_mixes = random_mixes(SCALE_MIXES, N_APPS, seed=SEED)
    small_mixes = random_mixes(SMALL_MIXES, N_APPS, seed=SEED)
    workloads = random_workloads(study["n_workloads"], study["apps"],
                                 study["seed"])
    plant = BatchedCMPPlant(small_mixes, device=DEVICE)
    spec = _manager_spec(plant, "CBP", SHARD_TIMELINE_MS, CBPParams())
    tl_kw = dict(total_units=plant.total_cache_units,
                 total_bandwidth=plant.total_bandwidth)
    n_mgr = len(EXPECTED_GEOMEANS)
    cases = {   # name: (shards, (groups, rows) of the split, run)
        "sweep_4096": (SHARD_FULL, (n_mgr, SCALE_MIXES), lambda: run_sweep(
            full_mixes, total_ms=TOTAL_MS, device=DEVICE)),
        "fig5_potential": (SHARD_FULL, (1, len(workloads)),
                           lambda: search_static(workloads, k=study["k"],
                                                 device=DEVICE)),
        "sweep_32": (SHARD_SMALL, (n_mgr, SMALL_MIXES), lambda: run_sweep(
            small_mixes, total_ms=TOTAL_MS, device=DEVICE)),
        "run_timeline": (SHARD_SMALL, (1, SMALL_MIXES),
                         lambda: timeline.run_timeline(
            plant.params, spec.schedule, variant=spec.variant,
            init_units=spec.init_units, init_bandwidth=spec.init_bandwidth,
            init_prefetch=spec.init_prefetch,
            cache_dynamic=spec.cache_dynamic,
            bandwidth_dynamic=spec.bandwidth_dynamic,
            cache_partitioned=spec.cache_partitioned,
            bandwidth_partitioned=spec.bandwidth_partitioned, **tl_kw)),
    }
    # On one card the default device list gives one shard: these runs are
    # the unsharded ones (run_timeline's is the K = 1 run_timelines).
    unsharded = {name: synced_wall(fn) for name, (_n, _g, fn)
                 in cases.items()}

    rows = {}
    sync()
    reset_launch_counts()
    for name, (n, (groups, n_rows), fn) in cases.items():
        with distributed.use_devices([torch.device(DEVICE, 0)
                                      if on_card() else DEVICE] * n):
            grid = distributed.grid_shard_counts(groups, n_rows)
            (got, wall), counts = counted(lambda: synced_wall(fn))
        want, want_wall = unsharded[name]
        if name == "fig5_potential":
            pairs = [pair for fam in want.family_names for pair in (
                (f"{fam} index", got.topk_index[fam], want.topk_index[fam]),
                (f"{fam} ws", got.topk_ws[fam], want.topk_ws[fam]))]
            pairs.append(("baseline", got.baseline_ipc, want.baseline_ipc))
        elif name == "run_timeline":
            pairs = [(f, getattr(got, f), getattr(want, f)) for f in (
                "ipc_acc", "cache_units", "bandwidth", "prefetch_on",
                "active")] + [("w_acc", got.w_acc, want.w_acc)]
        else:
            pairs = sweep_pairs(got, want)
        worst = shard_diff(pairs, f"shard {name}")
        greedy = counts.get("lookahead_greedy", 0)
        check(greedy > 0 or name == "fig5_potential",
              f"shard {name}: the greedy never launched")
        rows[name] = {"shards": n, "grid": list(grid), "wall_s": wall,
                      "unsharded_wall_s": want_wall,
                      "greedy_launches": greedy, **worst}
        emit(card, phase="shard", case=name, **rows[name],
             rtol=SHARD_RTOL, discrete_exact=True)
    counts = launch_counts()
    serving = serve_shards(card)
    check(serving.get("lookahead_greedy", 0) > 0,
          "shard: the serving blocks' greedy never launched")
    counts = {k: v + serving.get(k, 0) for k, v in counts.items()}
    check(counts["lookahead_greedy"] > 0,
          "shard: the greedy never launched")
    emit(card, phase="shard", case="summary",
         seconds=time.perf_counter() - t0, launches=counts,
         serving_launches=serving,
         max_abs_diff=max(r["max_abs_diff"] for r in rows.values()))
    return counts


# --------------------------------------------------------------------- #
# phase 18: the training mesh
# --------------------------------------------------------------------- #

#: (b) qwen3-8b at full width cut to TRAIN_FULL_LAYERS layers: AdamW
#: steps of TRAIN_FULL_B x TRAIN_FULL_S tokens at TRAIN_FULL_LR, with and
#: without the (1, 1) mesh.
MESH_FULL_STEPS = 2
#: (c) analytic_memory's figures for the full config: its chip counts,
#: with the (data, model) mesh each would run on.
MESH_FIT_CHIPS = {1: (1, 1), 4: (2, 2)}
CARD_BYTES = 80e9


def mesh_compare(got: dict, want: dict, what: str) -> dict:
    """A mesh run against the same steps without one: bit for bit, or
    else within phase 16(a)'s training bound (losses within atol 1e-5
    max(1, |loss|) + rtol 1e-4; parameters within 2 lr steps, and within
    that bound on at least 99.9 % of entries)."""
    import numpy as np
    import torch

    gl = torch.tensor(got["losses"], dtype=torch.float64)
    wl = torch.tensor(want["losses"], dtype=torch.float64)
    same = bool(torch.equal(gl, wl)) and all(
        np.array_equal(g, w) for g, w in zip(got["params"], want["params"]))
    rec = {"bit_for_bit": same,
           "loss_max_abs": float((gl - wl).abs().max()),
           "param_max_abs": max(float(np.abs(g - w).max())
                                for g, w in zip(got["params"],
                                                want["params"]))}
    if not same:
        check(bool(((gl - wl).abs() <= TRAIN_ATOL * max(
            1.0, float(wl.abs().max())) + TRAIN_RTOL * wl.abs()).all()),
              f"mesh {what}: losses {gl.tolist()} vs {wl.tolist()}")
        outside = total = 0
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            n, _ = train_outside(torch.from_numpy(g), torch.from_numpy(w),
                                 0.0, f"mesh {what} leaf {i}")
            outside, total = outside + n, total + w.size
        check(outside <= (1 - TRAIN_SHARE) * total,
              f"mesh {what}: {outside} of {total} entries past the bound")
        rec["entries_outside"] = outside
    return rec


def mesh_gate(card: str, mesh) -> dict:
    """(a) The reference's gate configs on the (1, 1) mesh against the
    same three AdamW steps without one, on the card."""
    import math

    from repro_torch import configs
    from repro_torch.launch import mesh_train as mt

    out = {}
    for arch in mt.GATE_ARCHS:
        cfg = mt.gate_config(configs.get_smoke(arch), (1, 1))
        batches = mt.gate_batches(cfg, mt.GATE_STEPS)
        want = mt.train_on_mesh(cfg, None, batches, device=DEVICE)
        got = mt.train_on_mesh(cfg, mesh, batches, device=DEVICE)
        losses = got["losses"]
        check(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              f"mesh {arch}: losses {losses} are not finite and falling")
        out[arch] = mesh_compare(got, want, arch)
        emit(card, phase="mesh", case="gate", config=arch,
             losses_mesh=losses, losses_plain=want["losses"], **out[arch])
    return out


def mesh_full(card: str, mesh) -> dict:
    """(b) qwen3-8b at full width cut to TRAIN_FULL_LAYERS layers, with
    and without the (1, 1) mesh, one run after the other (the first freed
    before the second): warm step times (the cost of DTensor dispatch),
    peak memory beside analytic_memory's prediction for one card."""
    import dataclasses
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import mesh_train as mt
    from repro_torch.launch.analytic import analytic_memory
    from repro_torch.models.model import ShapeSpec

    cfg = dataclasses.replace(configs.get("qwen3-8b"),
                              n_layers=TRAIN_FULL_LAYERS)
    src = SyntheticTokens(TRAIN_FULL_B, TRAIN_FULL_S, cfg.vocab_size, seed=1)
    batches = [next(src) for _ in range(MESH_FULL_STEPS)]
    predicted = analytic_memory(
        cfg, ShapeSpec("train", TRAIN_FULL_S, TRAIN_FULL_B, "train"), 1,
        "adamw")
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = mt.train_on_mesh(cfg, m, batches, device=DEVICE,
                                      lr=TRAIN_FULL_LR, microbatches=1)
    rec = mesh_compare(runs["mesh"], runs["plain"], "qwen3-8b full")
    tokens = TRAIN_FULL_B * TRAIN_FULL_S
    for name, r in runs.items():
        warm = r["step_s"][-1]
        rec[name] = {"losses": r["losses"], "step_s": r["step_s"],
                     "warm_step_s": warm, "tokens_per_s": tokens / warm,
                     "peak_bytes": r["peak_bytes"]}
    rec["dtensor_dispatch_s"] = (rec["mesh"]["warm_step_s"]
                                 - rec["plain"]["warm_step_s"])
    rec["analytic_bytes"] = predicted
    rec["peak_over_analytic"] = (rec["mesh"]["peak_bytes"]
                                 / predicted["total_bytes"])
    del runs
    emit(card, phase="mesh", case="qwen3-8b_full",
         config=f"qwen3-8b, {TRAIN_FULL_LAYERS} of 36 layers",
         tokens_per_step=tokens, **rec)
    return rec


def mesh_fit(card: str) -> dict:
    """(c) What fits: analytic_memory for the full 36-layer qwen3-8b with
    AdamW on 1 and on 4 cards (a (2, 2) mesh)."""
    from repro_torch import configs
    from repro_torch.launch.analytic import analytic_memory
    from repro_torch.models.model import ShapeSpec

    out = {}
    for chips, (dp, mdl) in MESH_FIT_CHIPS.items():
        cfg = configs.get("qwen3-8b").with_mesh(mdl, dp)
        mem = analytic_memory(
            cfg, ShapeSpec("train", TRAIN_FULL_S, TRAIN_FULL_B, "train"),
            chips, "adamw")
        out[chips] = {"mesh": [dp, mdl], **mem,
                      "fits_80gb": mem["total_bytes"] < CARD_BYTES}
    emit(card, phase="mesh", case="fit", config="qwen3-8b, 36 layers",
         chips=out)
    return out


def mesh_phase(card: str) -> dict:
    """Phase 18 on a (1, 1) ("data", "model") NCCL mesh of this process
    (one card is one rank), with the launch counts reset just before
    (a)-(b) and read just after (the mesh path launches no hand-written
    kernel); the process group ends with the phase."""
    import os
    import tempfile

    from repro_torch import distributed as D
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh_train as mt

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        D.start_ranks(os.path.join(tmp, "store"), 0, 1, DEVICE)
        try:
            mesh = D.make_mesh((1, 1), mt.AXES, DEVICE)
            reset_launch_counts()
            gate = mesh_gate(card, mesh)
            full = mesh_full(card, mesh)
            counts = launch_counts()
        finally:
            D.end_ranks()
    check(not any(counts.values()),
          f"mesh: a hand-written kernel launched: {counts}")
    fit = mesh_fit(card)
    emit(card, phase="mesh", case="summary",
         seconds=time.perf_counter() - t0, launches=counts,
         gate_bit_for_bit={k: v["bit_for_bit"] for k, v in gate.items()},
         full_bit_for_bit=full["bit_for_bit"],
         warm_step_s_mesh=full["mesh"]["warm_step_s"],
         warm_step_s_plain=full["plain"]["warm_step_s"],
         fits_1_card=fit[1]["fits_80gb"], fits_4_cards=fit[4]["fits_80gb"])
    return counts


# --------------------------------------------------------------------- #
# phase 19: the GPipe pipeline on a one-card mesh
# --------------------------------------------------------------------- #

#: (a) The CPU tests' gate cases at S = 1 (``tests/_torch_pipeline_ref.py``):
#: (layers, microbatches) of the reference gate's stack, D = 16,
#: microbatches of 8 rows, f32, inputs drawn by numpy from the case's
#: index.
PIPE_GATE_CASES = ((4, 4), (4, 1), (4, 3), (8, 4), (8, 2))
PIPE_GATE_D, PIPE_GATE_ROWS = 16, 8
#: (b) qwen3-8b at full width cut to TRAIN_FULL_LAYERS layers: microbatches
#: x rows x tokens, and the warm forward + backward runs of each path.
PIPE_MICRO, PIPE_ROWS, PIPE_SEQ, PIPE_WARM = 4, 1, 1024, 3
PIPE_AXES = ("pod", "data")


def pipe_gate_stage(w, x):
    """The reference gate's stage: ``x -> tanh(x @ w)`` for each layer."""
    import torch

    for wi in w:
        x = torch.tanh(x @ wi)
    return x


def pipe_outside(got, want) -> int:
    """Entries of ``got`` past PR 25's gradient bound around ``want``:
    ``1e-5 max(1, max|g|) + 1e-4 |g|``."""
    atol = TRAIN_ATOL * max(1.0, float(want.abs().max()))
    return int(((got - want).abs() > atol + TRAIN_RTOL * want.abs()).sum())


def pipe_gate(card: str, mesh) -> dict:
    """(a) The gate's stack on the pipeline over the (1, 1) mesh's "pod"
    axis, outputs and gradients of ``sum(out ** 2)``: bit for bit the
    port's sequential stack on the card, and within 1e-5 (outputs) and
    the gradient bound of the same stack on the CPU."""
    import numpy as np
    import torch
    from repro_torch.train.pipeline import pipeline_apply, place_stages

    out = {}
    for i, (layers, n) in enumerate(PIPE_GATE_CASES):
        rng = np.random.default_rng(i)
        ws_np = (rng.standard_normal((layers, PIPE_GATE_D, PIPE_GATE_D))
                 * 0.3).astype(np.float32)
        x_np = rng.standard_normal(
            (n, PIPE_GATE_ROWS, PIPE_GATE_D)).astype(np.float32)

        def leaves(dev):
            return (torch.from_numpy(ws_np).to(dev).requires_grad_(),
                    torch.from_numpy(x_np).to(dev).requires_grad_())

        def stack(dev):
            ws, x = leaves(dev)
            o = torch.stack([pipe_gate_stage(ws, xm) for xm in x])
            (o ** 2).sum().backward()
            return o.detach(), ws.grad, x.grad

        ws, x = leaves(DEVICE)
        stages = place_stages(ws, mesh)
        o = pipeline_apply(pipe_gate_stage, stages, x, mesh)
        (o ** 2).sum().backward()
        got = (o.detach(), stages.grad.full_tensor().reshape(ws.shape),
               x.grad)
        on_card, on_cpu = stack(DEVICE), stack("cpu")
        what = f"pipe gate L={layers} n_micro={n}"
        same = all(torch.equal(a, b) for a, b in zip(got, on_card))
        check(same, f"{what}: not bit for bit the card's stack")
        err = float((got[0].cpu() - on_cpu[0]).abs().max())
        check(err < 1e-5, f"{what}: outputs {err:.3g} from the CPU's")
        outside = sum(pipe_outside(g.cpu(), w)
                      for g, w in zip(got[1:], on_cpu[1:]))
        check(outside == 0, f"{what}: {outside} gradient entries past "
                            "the bound of the CPU's")
        out[f"L{layers}_n{n}"] = {
            "bit_for_bit_card_stack": same, "out_max_abs_vs_cpu": err,
            "grad_max_abs_vs_cpu": max(
                float((g.cpu() - w).abs().max())
                for g, w in zip(got[1:], on_cpu[1:]))}
    emit(card, phase="pipe", case="gate", cases=out)
    return out


def pipe_full(card: str, mesh) -> dict:
    """(b) qwen3-8b at full width cut to TRAIN_FULL_LAYERS layers (bf16,
    full remat): the loss of PIPE_MICRO microbatches of PIPE_ROWS x
    PIPE_SEQ tokens and its gradients, the layer stack on the pipeline
    (one stage) against ``transformer.forward`` a microbatch at a time
    (``train.pipeline.microbatch_loss``): loss and every layer gradient
    bit for bit; the first call's time, the warm forward + backward time
    (median of PIPE_WARM runs, the two paths in turns) and the peak
    memory of each (of the warm runs, each alone; the pipeline's first
    run also holds the plain run's gradients for the comparison)."""
    import dataclasses
    import gc
    import statistics

    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.pipeline import microbatch_loss, place_stages

    cfg = dataclasses.replace(configs.get("qwen3-8b"),
                              n_layers=TRAIN_FULL_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    model = build(cfg, DEVICE, seed=0).requires_grad_(True)
    batch = next(SyntheticTokens(PIPE_MICRO * PIPE_ROWS, PIPE_SEQ,
                                 cfg.vocab_size, seed=1))
    params = model.params
    layers = tree_leaves(params["layers"])
    rest = tree_leaves({k: v for k, v in params.items() if k != "layers"})
    stages = place_stages(params["layers"], mesh)

    def run(piped: bool):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if piped:
            loss = microbatch_loss(model, batch, PIPE_MICRO, mesh, stages)
            grads = torch.autograd.grad(loss, tree_leaves(stages) + rest)
        else:
            loss = microbatch_loss(model, batch, PIPE_MICRO)
            grads = torch.autograd.grad(loss, layers + rest)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grads = [g.full_tensor().reshape(p.shape) if i < len(layers)
                 and piped else g for i, (g, p) in
                 enumerate(zip(grads, layers + rest))]
        return loss.detach(), grads, wall, torch.cuda.max_memory_allocated()

    l_plain, g_plain, *plain = run(False)
    l_pipe, g_pipe, *pipe = run(True)
    runs = {"plain": [plain], "pipe": [pipe]}     # (wall, peak) each
    rec = {"loss_plain": float(l_plain), "loss_pipe": float(l_pipe),
           "loss_bit_for_bit": bool(torch.equal(l_plain, l_pipe)),
           "layer_grads_bit_for_bit": all(
               torch.equal(a, b) for a, b in zip(g_pipe[:len(layers)],
                                                 g_plain[:len(layers)])),
           "other_grads_bit_for_bit": all(
               torch.equal(a, b) for a, b in zip(g_pipe[len(layers):],
                                                 g_plain[len(layers):])),
           "grad_max_abs": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(g_pipe, g_plain))}
    check(math.isfinite(rec["loss_plain"]),
          f"pipe full: loss {rec['loss_plain']}")
    check(rec["loss_bit_for_bit"] and rec["layer_grads_bit_for_bit"],
          f"pipe full: not bit for bit the plain forward: {rec}")
    del g_plain, g_pipe
    for name, piped in (("plain", False), ("pipe", True)) * PIPE_WARM:
        gc.collect()
        runs[name].append(run(piped)[2:])
    tokens = PIPE_MICRO * PIPE_ROWS * PIPE_SEQ
    for name, rs in runs.items():
        warm = statistics.median(r[0] for r in rs[1:])
        rec[name] = {"first_s": rs[0][0], "walls_s": [r[0] for r in rs],
                     "warm_s": warm, "tokens_per_s": tokens / warm,
                     "peak_bytes": max(r[1] for r in rs[1:]),
                     "first_peak_bytes": rs[0][1]}
    del runs, stages, model, params, layers, rest
    torch.cuda.empty_cache()
    emit(card, phase="pipe", case="qwen3-8b_full",
         config=f"qwen3-8b, {TRAIN_FULL_LAYERS} of 36 layers, bf16, "
                f"remat {cfg.remat}",
         microbatches=[PIPE_MICRO, PIPE_ROWS, PIPE_SEQ],
         tokens_per_step=tokens, **rec)
    return rec


def pipe_phase(card: str) -> dict:
    """Phase 19 on a (1, 1) ("pod", "data") NCCL mesh of this process
    (one card is one rank, one stage), with the launch counts reset just
    before (a)-(b) and read just after (the pipeline launches no
    hand-written kernel); the process group ends with the phase."""
    import os
    import tempfile

    from repro_torch import distributed as D
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pipe_") as tmp:
        D.start_ranks(os.path.join(tmp, "store"), 0, 1, DEVICE)
        try:
            mesh = D.make_mesh((1, 1), PIPE_AXES, DEVICE)
            reset_launch_counts()
            gate = pipe_gate(card, mesh)
            full = pipe_full(card, mesh)
            counts = launch_counts()
        finally:
            D.end_ranks()
    check(not any(counts.values()),
          f"pipe: a hand-written kernel launched: {counts}")
    emit(card, phase="pipe", case="summary",
         seconds=time.perf_counter() - t0, launches=counts,
         gate_cases=len(gate),
         full_bit_for_bit=full["layer_grads_bit_for_bit"],
         warm_s_pipe=full["pipe"]["warm_s"],
         warm_s_plain=full["plain"]["warm_s"])
    return counts


# --------------------------------------------------------------------- #
# phase 20: the dry run, in a process of its own
# --------------------------------------------------------------------- #

#: (b) The production cell the phase runs: (arch, shape, mesh).
DRY_CELL = ("qwen3-8b", "train_4k", "single")
#: (c) Cells that PyTorch 2.11 failed before the mesh faults' repairs,
#: each cut to a few layers: (arch, shape, mesh, layers).  zamba2-7b's
#: Mamba blocks asked it for a ``Shard -> Partial``; grok-1-314b's MoE
#: backward viewed a gradient whose shards its strides misstated.
DRY_FAULT_CELLS = (("zamba2-7b", "train_4k", "single", 1),
                   ("zamba2-7b", "prefill_32k", "single", 2),
                   ("grok-1-314b", "decode_32k", "single", 2),
                   ("grok-1-314b", "train_4k", "multi", 1))
#: (d) The Fig. 5 seeded climb (``repro_torch.launch.hillclimb``) at the
#: reference's defaults: (workloads, seeds); and how far the card's
#: weighted speedups may lie from the CPU's (relative).
DRY_FIG5 = (4, 4)
DRY_FIG5_RTOL = 1e-9
#: (a) The peak estimate's largest share off the real step's
#: ``max_memory_allocated``.
DRY_PEAK_RTOL = 0.15
#: Seconds each of the phase's subprocesses may take, from its start.
DRY_TIMEOUT = 400


def dry_worker(part: str, out_path: str) -> int:
    """Phase 20's work, run as ``python3 chip_smoke.py --dry-worker PART
    OUT`` (a fake process group is process state).  ``step``: (a) phase
    16(c)'s cell counted on a fake (1, 1) group with a card mesh, then the
    same step run for real on the card, counted by ``FlopCounterMode``;
    ``cell``: (b) the production cell ``DRY_CELL``, on ``meta`` tensors
    alone.  Either writes one JSON object, with the launch counts over its
    work, to ``out_path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import importlib
    import statistics
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import dryrun, op_costs
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build
    from repro_torch.models.model import ShapeSpec
    from repro_torch.train import TrainStepConfig, build_train_step

    from repro_torch.kernels import build as kernel_build

    for name in kernel_build.SOURCES:   # every kernel's launch counter
        importlib.import_module(f"repro_torch.kernels.{name}.ops")
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    out = {}
    if part == "cell":
        # (b) one production cell on a fake group of 256 ranks, card mesh
        arch, shape, mesh_kind = DRY_CELL
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            out["cell"] = dryrun.run_cell(arch, shape, mesh_kind,
                                          force=True, device=DEVICE,
                                          results_dir=tmp)
            out["cell_wall_s"] = time.perf_counter() - t0
            # (c) the cells 2.11 failed before the repairs, cut in depth
            real_get = configs.get
            out["fault_cells"] = []
            for arch, shape, mesh_kind, layers in DRY_FAULT_CELLS:
                configs.get = lambda name, n=layers: dataclasses.replace(
                    real_get(name), n_layers=n)
                try:
                    out["fault_cells"].append(dryrun.run_cell(
                        arch, shape, mesh_kind, force=True, device=DEVICE,
                        results_dir=tmp))
                finally:
                    configs.get = real_get
        # (d) the Fig. 5 climb on the CPU, which the card's is held to
        from repro_torch.launch import hillclimb
        t0 = time.perf_counter()
        out["fig5_cpu"] = hillclimb.climb_rows(*DRY_FIG5, device="cpu")
        out["fig5_cpu_s"] = time.perf_counter() - t0
        out["launches"] = launch_counts()
        Path(out_path).write_text(json.dumps(out))
        return 0

    cfg = dataclasses.replace(configs.get("qwen3-8b"),
                              n_layers=TRAIN_FULL_LAYERS)
    spec = ShapeSpec("train", TRAIN_FULL_S, TRAIN_FULL_B, "train")

    # (a) the dry cell: rank 0 of a fake (1, 1) group, meta tensors
    D.start_fake_ranks(1)
    try:
        mesh = D.make_mesh((1, 1), ("data", "model"), DEVICE)
        D.set_dp_axes(sh.dp_axes_for(cfg))
        with D.use_mesh(mesh):
            t0 = time.perf_counter()
            fn, args = dryrun.build_cell(dryrun.meta_model(cfg), spec, mesh,
                                         "adamw", 1)
            _, cost, counter = op_costs.trace(fn, *args)
            out["trace_s"] = time.perf_counter() - t0
        out["dry"] = dryrun.record(cfg, spec, 1, "adamw", cost, counter)
    finally:
        D.set_dp_axes(D.DP_AXES)
        D.end_ranks()

    # (a) the same step for real on the card: a cold step, one for the
    # peak, one under FlopCounterMode, two warm
    model = build(cfg, DEVICE, seed=0)
    init_opt, step = build_train_step(model, TrainStepConfig(
        optimizer="adamw", lr=TRAIN_FULL_LR))
    params = model.params
    opt = init_opt(params)
    batches = SyntheticTokens(TRAIN_FULL_B, TRAIN_FULL_S, cfg.vocab_size,
                              seed=1)
    (params, opt, _), cold = synced_wall(
        lambda: step(params, opt, next(batches)))
    torch.cuda.reset_peak_memory_stats()
    (params, opt, _), wall = synced_wall(
        lambda: step(params, opt, next(batches)))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as fc:
        params, opt, _ = step(params, opt, next(batches))
    out["flop_counter_flops"] = float(fc.get_total_flops())
    walls = [wall]
    for _ in range(2):
        (params, opt, _), wall = synced_wall(
            lambda: step(params, opt, next(batches)))
        walls.append(wall)
    out["cold_step_s"], out["warm_step_s"] = cold, statistics.median(walls)
    out["launches"] = launch_counts()
    Path(out_path).write_text(json.dumps(out))
    return 0


class DryWorker:
    """One part of :func:`dry_worker` in a subprocess of its own, its
    output and errors in a temporary directory."""

    def __init__(self, part: str):
        import tempfile

        self.part = part
        self.tmp = tempfile.TemporaryDirectory(prefix=f"dry_{part}_")
        self.out_path = Path(self.tmp.name) / "out.json"
        self.err = open(Path(self.tmp.name) / "stderr.txt", "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dry-worker",
             part, str(self.out_path)],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=self.err, text=True)

    def result(self) -> dict:
        """Wait for the worker (up to DRY_TIMEOUT from its start) and
        return what it wrote; a worker that fails or runs past its time
        fails the phase."""
        left = DRY_TIMEOUT - (time.perf_counter() - self.t0)
        try:
            self.proc.wait(timeout=max(left, 0.0))
        except subprocess.TimeoutExpired:
            self.stop()
            raise SmokeFailure(f"dry: the {self.part} worker ran past "
                               f"{DRY_TIMEOUT} s")
        self.err.seek(0)
        check(self.proc.returncode == 0 and self.out_path.exists(),
              f"dry: the {self.part} worker failed "
              f"({self.proc.returncode}):\n{self.err.read()[-3000:]}")
        return json.loads(self.out_path.read_text())

    def stop(self) -> None:
        """End the worker if it still runs, and remove its files."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        self.tmp.cleanup()


def dry_phase(card: str, cell_worker: DryWorker) -> dict:
    """Phase 20: :func:`dry_worker`'s two parts in subprocesses (the
    launch counts are reset just before each part's work and read just
    after, in it; the counts returned are their sums).  (b) the production
    cell needs no card: ``cell_worker`` ran it beside the earlier phases
    (it started after the build); (a) the step runs now.  (a) The counted
    FLOPs of phase 16(c)'s cell equal ``FlopCounterMode``'s count of the
    real step exactly, and the peak estimate is within DRY_PEAK_RTOL of
    the real step's ``max_memory_allocated``; (b) the production cell's
    status is ``ok``.  Prints the step-time bound beside the warm step,
    and the production cell's counts, dominant term, trace seconds and
    per-device peak beside ``analytic_memory``."""
    import gc

    import torch
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()   # the subprocess needs the card's memory
    step_worker = DryWorker("step")
    try:
        res = step_worker.result()
    finally:
        step_worker.stop()
    cell_res = cell_worker.result()
    dry, cell = res["dry"], cell_res["cell"]
    counted = dry["counted"]["flops_per_device"]
    check(counted == res["flop_counter_flops"],
          f"dry (a): counted FLOPs {counted} != FlopCounterMode's "
          f"{res['flop_counter_flops']} of the real step")
    estimate = dry["memory"]["peak_estimate_bytes"]
    share = abs(estimate - res["peak_bytes"]) / res["peak_bytes"]
    emit(card, phase="dry", case="qwen3-8b_8_layers_1x1",
         flops_counted=counted, flops_real=res["flop_counter_flops"],
         flops_global=dry["counted"]["flops_global"],
         peak_estimate_bytes=estimate, max_memory_allocated=res["peak_bytes"],
         peak_share_off=share, argument_bytes=dry["memory"]["argument_bytes"],
         analytic=dry["memory"]["analytic"],
         step_time_bound_s=dry["roofline"]["step_time_bound_s"],
         dominant=dry["roofline"]["dominant"],
         roofline=dry["roofline"], warm_step_s=res["warm_step_s"],
         cold_step_s=res["cold_step_s"], trace_s=res["trace_s"])
    check(share <= DRY_PEAK_RTOL,
          f"dry (a): peak estimate {estimate} is {share:.3f} off the real "
          f"step's {res['peak_bytes']} (limit {DRY_PEAK_RTOL})")
    check(cell["status"] == "ok",
          f"dry (b): {'/'.join(DRY_CELL)} {cell['status']}: "
          f"{cell.get('error')}\n{cell.get('traceback', '')[-2000:]}")
    emit(card, phase="dry", case="/".join(DRY_CELL), chips=cell["chips"],
         counted=cell["counted"], dominant=cell["roofline"]["dominant"],
         roofline=cell["roofline"], trace_s=cell["trace_s"],
         build_s=cell["build_s"], worker_wall_s=cell_res["cell_wall_s"],
         peak_estimate_bytes=cell["memory"]["peak_estimate_bytes"],
         argument_bytes=cell["memory"]["argument_bytes"],
         analytic=cell["memory"]["analytic"])
    for (arch, shape, mesh_kind, layers), rec in zip(
            DRY_FAULT_CELLS, cell_res["fault_cells"]):
        check(rec["status"] == "ok",
              f"dry (c): {arch}/{shape}/{mesh_kind} at {layers} layers "
              f"{rec['status']}: {rec.get('error')}\n"
              f"{rec.get('traceback', '')[-2000:]}")
        emit(card, phase="dry", case=f"{arch}/{shape}/{mesh_kind}",
             layers=layers, chips=rec["chips"], trace_s=rec["trace_s"],
             flops_per_device=rec["counted"]["flops_per_device"],
             peak_estimate_bytes=rec["memory"]["peak_estimate_bytes"],
             dominant=rec["roofline"]["dominant"])
    fig5_phase(card, cell_res["fig5_cpu"], cell_res["fig5_cpu_s"])
    counts = {k: v + cell_res["launches"].get(k, 0)
              for k, v in res["launches"].items()}
    check(set(build.SOURCES) <= set(counts) and not any(counts.values()),
          f"dry: a hand-written kernel launched: {counts}")
    emit(card, phase="dry", case="summary",
         seconds=time.perf_counter() - t0, launches=counts)
    return counts


def fig5_phase(card: str, cpu_rows: list, cpu_s: float) -> None:
    """Phase 20(d): the Fig. 5 seeded climb at DRY_FIG5 on the card (the
    static search and every score there, in float64), held to the CPU's
    climb ``cpu_rows``: each workload's allocation equal, or tied within
    DRY_FIG5_RTOL under the CPU's model where the card's search seeded
    from a twin index; each weighted speedup within DRY_FIG5_RTOL."""
    import numpy as np
    import torch

    from repro_torch.launch import hillclimb
    from repro_torch.sim import memsys
    from repro_torch.sim.apps import app_fields, from_numpy, stack
    from repro_torch.sim.runner import equal_share
    from repro_torch.sim.static_search import (FIG5_FAMILIES, StaticOptions,
                                               family_grid)

    def ws_cpu(workload, config):
        n = len(workload)
        grid = family_grid(FIG5_FAMILIES[hillclimb.FIG5_FAMILY], n,
                           StaticOptions())
        params = from_numpy(app_fields(stack(workload)),
                            torch.device("cpu"))

        def ipc(c, b, p):
            return memsys.evaluate(
                params, np.asarray(c, dtype=np.float64), np.asarray(b),
                np.asarray(p), total_cache_units=grid.total_cache_units,
                total_bandwidth_gbps=grid.total_bandwidth_gbps,
                iters=40).ipc

        units, bw = equal_share(n, grid.total_cache_units,
                                grid.total_bandwidth_gbps)
        return float(torch.mean(
            ipc(config["cache_units"], config["bandwidth_gbps"],
                config["prefetch_on"]) / ipc(units, bw, np.zeros(n))))

    t0 = time.perf_counter()
    rows = hillclimb.climb_rows(*DRY_FIG5, device=DEVICE)
    sync()
    card_s = time.perf_counter() - t0
    ties, worst = 0, 0.0
    for got, want in zip(rows, cpu_rows):
        check(got["workload"] == want["workload"],
              f"dry (d): workloads {got['workload']} / {want['workload']}")
        if got["config"] != want["config"]:
            a = ws_cpu(got["workload"], got["config"])
            b = ws_cpu(want["workload"], want["config"])
            check(abs(a - b) <= DRY_FIG5_RTOL * abs(b),
                  f"dry (d): {got['workload']} climbed to {got['config']} "
                  f"on the card, {want['config']} on the CPU, ws {a} / {b}")
            ties += 1
        off = abs(got["refined_ws"] - want["refined_ws"]) / want["refined_ws"]
        worst = max(worst, off)
        check(off <= DRY_FIG5_RTOL,
              f"dry (d): {got['workload']} refined ws {got['refined_ws']} "
              f"on the card, {want['refined_ws']} on the CPU")
    emit(card, phase="dry", case="fig5_seed", workloads=DRY_FIG5[0],
         seeds=DRY_FIG5[1], card_s=card_s, cpu_s=cpu_s, ties=ties,
         largest_rel_diff=worst,
         refined_ws=[r["refined_ws"] for r in rows],
         grid_best_ws=[r["grid_best_ws"] for r in rows])


def sync() -> None:
    import torch

    if on_card():
        torch.cuda.synchronize()


def memory_probe(card: str, after: str) -> None:
    """Device memory that reference cycles hold once a phase is over: the
    bytes allocated, then a collector pass that saves what it finds (the
    port's classes among it counted by name), then the bytes it freed."""
    import collections
    import gc

    import torch

    sync()
    held = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        owners = collections.Counter(
            type(o).__qualname__ for o in gc.garbage
            if type(o).__module__.startswith("repro_torch"))
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    gc.collect()
    sync()
    emit(card, phase="memory", after=after, allocated_bytes=held,
         freed_by_collect_bytes=held - torch.cuda.memory_allocated(),
         cycle_owners=dict(owners))


# --------------------------------------------------------------------- #
# phases 5-6: the kernel-level path (UCP block planner + four kernels)
# --------------------------------------------------------------------- #

def default_knobs(name: str) -> dict:
    """The block knobs of a kernel's wrapper signature, at their defaults."""
    params = inspect.signature(kernel_fns(name)[0]).parameters.values()
    return {p.name: p.default for p in params
            if p.name.startswith("block_") or p.name == "chunk"}


def kernel_fns(name: str):
    """(wrapper, plain version) of one kernel of the path."""
    from repro_torch.kernels import (cbp_matmul, flash_attention,
                                     flash_decode, ssd_scan)

    return {
        "cbp_matmul": (cbp_matmul.cbp_matmul, cbp_matmul.cbp_matmul_plain),
        "flash_attention": (flash_attention.flash_attention,
                            flash_attention.flash_attention_plain),
        "flash_decode": (flash_decode.flash_decode,
                         flash_decode.flash_decode_plain),
        "ssd_scan": (ssd_scan.ssd_scan, ssd_scan.ssd_scan_plain),
    }[name]


def plan_phase(card: str):
    """The planner on the card for the record's and the full-width specs;
    returns (record knobs, full-width knobs, budget)."""
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.runtime.cbp_runtime import plan_kernel_blocks

    budget = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    full = [dict(spec, budget_bytes=budget) for spec in FULL_SPECS]
    plans, launches = {}, {}
    for label, specs, groups in (("record", RECORD_SPECS, RECORD_GROUPS),
                                 ("full", full, 1)):
        reset_launch_counts()
        knobs = plan_kernel_blocks(specs)
        launches[label] = launch_counts()["lookahead_greedy"]
        cpu = plan_kernel_blocks(specs, device="cpu")
        check(knobs == cpu, f"{label} plan on the card {knobs} != the "
                            f"CPU plan {cpu}")
        check(launches[label] == groups,
              f"{label} plan launched the greedy {launches[label]} times "
              f"for {groups} capacity groups")
        plans[label] = knobs
    check(plans["record"] == EXPECTED_RECORD_KNOBS,
          f"record plan {plans['record']} != kernel_blocks.json "
          f"{EXPECTED_RECORD_KNOBS}")
    runtime_blocks = runtime_plan(launches)
    emit(card, phase="plan", budget_bytes=budget,
         record_knobs=plans["record"], full_knobs=plans["full"],
         runtime_bench_blocks=runtime_blocks, greedy_launches=launches)
    return plans["record"], plans["full"], budget


def runtime_plan(launches: dict):
    """``runtime_bench``'s planner half: its PLAN_SHAPES planned on the
    card in one greedy launch, equal to the scalar numpy planner (the
    port's host golden greedy per shape) and to the committed record's
    ``planner_blocks``."""
    from repro_torch.core import cache_controller_numpy as ccn
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.runtime import cbp_runtime as rt

    reset_launch_counts()
    blocks = [list(b) for b in
              rt.plan_matmul_blocks_batched(list(RUNTIME_PLAN_SHAPES))]
    launches["runtime_bench"] = launch_counts()["lookahead_greedy"]
    check(launches["runtime_bench"] == 1,
          f"runtime_bench's shapes took {launches['runtime_bench']} greedy "
          f"launches, not one")
    units = rt._total_units(rt.DEFAULT_BUDGET_BYTES)
    scalar = []
    for m, n, k in RUNTIME_PLAN_SHAPES:
        curves = rt._tile_utility_curves(m, n, k, 2, rt._PLAN_UNIT, units)
        alloc = ccn.lookahead_allocate(curves, units, rt._PLAN_MIN_UNITS)
        scalar.append(list(rt._plan_from_alloc(m, n, k, alloc, 2)))
    record = json.loads(RUNTIME_RECORD.read_text())["derived"][
        "planner_blocks"]
    check(blocks == scalar, f"runtime_bench plan {blocks} != the scalar "
                            f"numpy planner's {scalar}")
    check(blocks == record, f"runtime_bench plan {blocks} != the record's "
                            f"{record}")
    return blocks


def ssd_inputs(gen, b, s, h, p, n, dtype, device):
    import torch
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return (r(b, s, h, p).to(dtype), (F.softplus(r(b, s, h)) * 0.5).to(dtype),
            -torch.exp(r(h) * 0.3), (r(b, s, n) * 0.5).to(dtype),
            (r(b, s, n) * 0.5).to(dtype))


def full_inputs(gen) -> dict:
    """Full-width inputs on the card, from a seeded generator: {kernel:
    (args, kwargs)} (decode at the first of DECODE_LENS)."""
    import torch

    bf = torch.bfloat16

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    H, S, D, HKV = 32, 4096, 128, 8
    kv = [r(1, HKV, S, D).repeat_interleave(H // HKV, dim=1).contiguous()
          for _ in range(2)]
    lens = torch.tensor(DECODE_LENS[0], dtype=torch.int32, device="cuda")
    return {
        "cbp_matmul": ((r(4096, 4096), r(4096, 12288)), {}),
        "flash_attention": ((r(1, H, S, D), *kv), {"causal": True}),
        "flash_decode": ((r(8, H, D), r(8, H, 8192, D), r(8, H, 8192, D),
                          lens), {}),
        "ssd_scan": (ssd_inputs(gen, 2, 4096, 64, 64, 128, torch.float32,
                                "cuda"), {}),
    }


def record_inputs(gen) -> dict:
    """The kernel_block_plan_bench shapes (f32), on the card."""
    import torch

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return {
        "cbp_matmul": ((r(512, 512), r(512, 512)), {}),
        "flash_attention": ((r(1, 4, 512, 64), r(1, 4, 512, 64),
                             r(1, 4, 512, 64)), {"causal": True}),
        "flash_decode": ((r(4, 8, 64), r(4, 8, 2048, 64), r(4, 8, 2048, 64),
                          2048), {}),
        "ssd_scan": (ssd_inputs(gen, 1, 512, 4, 16, 32, torch.float32,
                                "cuda"), {}),
    }


def compare(name: str, got, want, what: str) -> float:
    """Max abs difference of two outputs of one dtype; fails beyond the
    kernel's limits (``repro_torch.kernels.tolerance``), or on a
    non-finite value."""
    import torch
    from repro_torch.kernels.tolerance import limits

    check(got.dtype == want.dtype,
          f"{name} {what}: dtype {got.dtype} != {want.dtype}")
    atol, rtol = limits(name, want)
    g, w = got.float(), want.float().to(got.device)
    check(g.shape == w.shape and bool(torch.isfinite(g).all()),
          f"{name} {what}: shape {tuple(g.shape)} or non-finite values")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    check(bool(torch.allclose(g, w, atol=atol, rtol=rtol)),
          f"{name} {what}: max abs err {err} beyond atol {atol} + rtol "
          f"{rtol} x |plain|")
    return err


def time_ms(fn) -> float:
    """CUDA-event time of one call: a warm-up, then as many calls as fill
    about 100 ms (1 to 50)."""
    import torch

    fn()
    torch.cuda.synchronize()
    once = cuda_ms(fn, 1)
    return cuda_ms(fn, max(1, min(50, int(100.0 / max(once, 1e-3)))))


def kernel_work(name: str, args, kw: dict):
    """(bytes, operations, ops/s) the function needs on these inputs,
    whatever the knobs: each input read once and the output written once;
    operations counted as this run's data needs them (the causal triangle,
    the live cache, the SSD's chunked form at the call's chunk); the rate
    is the bf16 tensor-core rate, a third of the TF32 rate for the f32
    matmul and attention (3xTF32), a third of the bf16 rate for the f32
    SSD scan (three bf16 products), else the f32 CUDA-core rate."""
    import torch

    rate = (BF16_TC_OPS_PER_S if args[0].dtype == torch.bfloat16
            else FP32_OPS_PER_S)
    if name in ("cbp_matmul", "flash_attention") and \
            args[0].dtype == torch.float32:
        rate = TF32_TC_OPS_PER_S / 3   # 3xTF32 on the tensor cores
    if name == "ssd_scan" and args[0].dtype == torch.float32:
        rate = BF16_TC_OPS_PER_S / 3   # hi*hi + hi*lo + lo*hi in bf16
    elt = args[0].element_size()
    if name == "cbp_matmul":
        a, b = args
        (M, K), N = a.shape, b.shape[1]
        return (a.numel() + b.numel() + M * N) * elt, 2 * M * N * K, rate
    if name == "flash_attention":
        q, k, v = args
        B, H, Sq, D = q.shape
        Sk = k.shape[2]
        live = (sum(min(i + 1, Sk) for i in range(Sq)) if kw["causal"]
                else Sq * Sk)
        return ((2 * q.numel() + k.numel() + v.numel()) * elt,
                4 * B * H * D * live, rate)
    if name == "flash_decode":
        q, k, v, cur_len = args
        B, H, D = q.shape
        L = max(0, min(int(cur_len), k.shape[2]))
        return ((2 * q.numel() + 2 * B * H * L * D) * elt + 4,
                4 * B * H * L * D, rate)
    # SSD in its chunked form at the call's chunk L: per (batch row,
    # chunk) the lower triangle of C.B^T (B and C are shared by the
    # heads: N L (L + 1)); per (batch, head, chunk) the masked M (x dt)
    # (P L (L + 1)), C.state^T and the state update (2 L N P each).
    x, dt, A, Bm, Cm = args
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = int(kw.get("chunk", 128))
    n_chunks = B * (S // L)
    ops = n_chunks * (N * L * (L + 1)
                      + H * (P * L * (L + 1) + 4 * L * N * P))
    n_bytes = (2 * x.numel() + dt.numel() + Bm.numel() + Cm.numel()) * elt
    return n_bytes + 4 * A.numel(), ops, rate


def library_call(name: str, args, kw: dict):
    """One PyTorch call computing the same function, or None."""
    import torch
    import torch.nn.functional as F

    if name == "cbp_matmul":
        return lambda: torch.matmul(*args)
    if name == "flash_attention":
        return lambda: F.scaled_dot_product_attention(
            *args, is_causal=kw["causal"])
    if name == "flash_decode":
        q, k, v, cur_len = args
        L = int(cur_len)
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], k[:, :, :L], v[:, :, :L])[:, :, 0]
    return None


def drive_kernel_path(full: dict, budget: int):
    """The kernel-level path once, with the launch counts reset just
    before it: plan the four kernels' knobs at ``budget``, run each under
    them.  Returns (knobs, outputs, launch counts)."""
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.runtime.cbp_runtime import plan_kernel_blocks

    torch.cuda.synchronize()
    reset_launch_counts()
    knobs = plan_kernel_blocks(
        [dict(spec, budget_bytes=budget) for spec in FULL_SPECS])
    outs = {}
    for spec, kn in zip(FULL_SPECS, knobs):
        args, kw = full[spec["kernel"]]
        outs[spec["kernel"]] = kernel_fns(spec["kernel"])[0](*args, **kw,
                                                             **kn)
    torch.cuda.synchronize()
    return knobs, outs, launch_counts()


def f32_full_inputs(gen, name: str):
    """Full-width float32 inputs for ``name`` drawn from ``gen``: the
    qwen3-8b FFN matmul, or its prefill attention (k/v repeated from 8
    heads, causal).  Drawn in f32, since bf16 values would leave 3xTF32's
    low parts zero."""
    import torch

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if name == "cbp_matmul":
        return (r(4096, 4096), r(4096, 12288)), {}
    H, S, D, HKV = 32, 4096, 128, 8
    kv = [r(1, HKV, S, D).repeat_interleave(H // HKV, dim=1).contiguous()
          for _ in range(2)]
    return (r(1, H, S, D), *kv), {"causal": True}


def f32_full(card: str, gen, name: str, kn_a: dict) -> float:
    """``name`` (``cbp_matmul`` or ``flash_attention``) in float32 at the
    full-width shape, planned knobs (a) and defaults (b), against its
    plain version at the f32 tolerance, and timed beside the PyTorch call
    in float32 (TF32 off, as stated on the line).  Returns the larger
    error."""
    import torch

    kfn, pfn = kernel_fns(name)
    args, kw = f32_full_inputs(gen, name)
    kn_b = default_knobs(name)
    plain = pfn(*args, **kw)
    out_a, out_b = kfn(*args, **kw, **kn_a), kfn(*args, **kw, **kn_b)
    torch.cuda.synchronize()
    what = "full width f32, knobs"
    err = max(compare(name, out_a, plain, what + " (a)"),
              compare(name, out_b, plain, what + " (b)"))
    del out_a, out_b, plain
    n_bytes, n_ops, rate = kernel_work(name, args, {**kw, **kn_a})
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    emit(card, phase="kernels", name=name, case="full_f32",
         shape=[list(t.shape) for t in args], dtype="float32",
         knobs_a=kn_a, knobs_b=kn_b,
         ms=time_ms(lambda: kfn(*args, **kw, **kn_a)),
         ms_b=time_ms(lambda: kfn(*args, **kw, **kn_b)),
         plain_ms=time_ms(lambda: pfn(*args, **kw)),
         library_ms=time_ms(library_call(name, args, kw)),
         library_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         bytes=n_bytes, operations=n_ops, bound_ms=max(t_bytes, t_ops),
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         max_abs_err=err)
    return err


def ssd_bf16_full(card: str, gen, kn_a: dict) -> dict:
    """``ssd_scan`` in bfloat16, mamba2's parameter dtype, at the
    full-width shape: planned knobs (a) and defaults (b) against the
    plain version at the bf16 limits, timed beside its bound.  Returns
    the emitted record."""
    import torch

    kfn, pfn = kernel_fns("ssd_scan")
    args = ssd_inputs(gen, 2, 4096, 64, 64, 128, torch.bfloat16, "cuda")
    kn_b = default_knobs("ssd_scan")
    plain = pfn(*args)
    out_a, out_b = kfn(*args, **kn_a), kfn(*args, **kn_b)
    torch.cuda.synchronize()
    what = "full width bf16, knobs"
    err = max(compare("ssd_scan", out_a, plain, what + " (a)"),
              compare("ssd_scan", out_b, plain, what + " (b)"))
    del out_a, out_b, plain
    n_bytes, n_ops, rate = kernel_work("ssd_scan", args, kn_a)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    rec = {"shape": [list(t.shape) for t in args], "dtype": "bfloat16",
           "knobs_a": kn_a, "knobs_b": kn_b,
           "ms": time_ms(lambda: kfn(*args, **kn_a)),
           "ms_b": time_ms(lambda: kfn(*args, **kn_b)),
           "plain_ms": time_ms(lambda: pfn(*args)), "library_ms": None,
           "bytes": n_bytes, "operations": n_ops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    emit(card, phase="kernels", name="ssd_scan", case="full_bf16", **rec)
    return rec


def kernels_phase(card: str, record_knobs, full_knobs, budget):
    """Drive the path, then hold every kernel to its plain version and
    time it; returns the rows of the ``kernels`` line and the path's
    launch counts."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    full = full_inputs(gen)
    knobs_a, outs, counts = drive_kernel_path(full, budget)
    check(knobs_a == full_knobs, f"path plan {knobs_a} != phase 5's "
                                 f"{full_knobs}")
    check(counts["lookahead_greedy"] == 1,
          f"the path's plan launched the greedy {counts['lookahead_greedy']}"
          f" times, not once")
    for name in REPLACES:
        check(counts[name] >= 1, f"the kernel path did not launch {name}")
    errs = {name: 0.0 for name in REPLACES}
    rows = {}

    # Full width, planned knobs (a) against the defaults (b).
    for spec, kn_a in zip(FULL_SPECS, knobs_a):
        name = spec["kernel"]
        kfn, pfn = kernel_fns(name)
        args, kw = full[name]
        lens = DECODE_LENS if name == "flash_decode" else (None,)
        for cur_len in lens:
            if cur_len is not None:
                args = (*args[:3], torch.tensor(cur_len, dtype=torch.int32,
                                                device="cuda"))
            kn_b = default_knobs(name)
            out_a = (outs[name] if cur_len in (None, DECODE_LENS[0])
                     else kfn(*args, **kw, **kn_a))
            out_b = kfn(*args, **kw, **kn_b)
            plain = pfn(*args, **kw)
            torch.cuda.synchronize()
            what = ("full width" if cur_len is None
                    else f"full width, cur_len={cur_len}")
            err = max(compare(name, out_a, plain, what + ", knobs (a)"),
                      compare(name, out_b, plain, what + ", knobs (b)"))
            err_ab = compare(name, out_a, out_b, what + ", (a) vs (b)")
            del out_a, out_b, plain
            errs[name] = max(errs[name], err)
            ms_a = time_ms(lambda: kfn(*args, **kw, **kn_a))
            ms_b = time_ms(lambda: kfn(*args, **kw, **kn_b))
            plain_ms = time_ms(lambda: pfn(*args, **kw))
            lib = library_call(name, args, kw)
            library_ms = time_ms(lib) if lib is not None else None
            n_bytes, n_ops, rate = kernel_work(name, args, {**kw, **kn_a})
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / rate * 1e3
            rec = {"shape": [list(t.shape) for t in args
                             if isinstance(t, torch.Tensor) and t.dim()],
                   "dtype": str(args[0].dtype).split(".")[-1],
                   "cur_len": cur_len, "knobs_a": kn_a, "knobs_b": kn_b,
                   "ms": ms_a, "ms_b": ms_b, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bytes": n_bytes,
                   "operations": n_ops, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "max_abs_err": err, "max_abs_err_a_vs_b": err_ab}
            emit(card, phase="kernels", name=name, case="full", **rec)
            rows.setdefault(name, rec)

    for i, name in ((0, "cbp_matmul"), (1, "flash_attention")):
        errs[name] = max(errs[name], f32_full(card, gen, name, knobs_a[i]))
    ssd_bf16 = ssd_bf16_full(card, gen, knobs_a[3])

    # The record's shapes (f32): planned and default knobs, against the
    # plain version on the card and on the CPU.
    rec_in = record_inputs(gen)
    for spec, kn in zip(RECORD_SPECS, record_knobs):
        name = spec["kernel"]
        kfn, pfn = kernel_fns(name)
        args, kw = rec_in[name]
        out_a = kfn(*args, **kw, **kn)
        out_b = kfn(*args, **kw, **default_knobs(name))
        plain = pfn(*args, **kw)
        cpu_args = [t.cpu() if isinstance(t, torch.Tensor) else t
                    for t in args]
        plain_cpu = pfn(*cpu_args, **kw)
        torch.cuda.synchronize()
        err = max(compare(name, out_a, plain, "record, planned knobs"),
                  compare(name, out_b, plain, "record, default knobs"),
                  compare(name, out_a, plain_cpu, "record vs CPU plain"))
        compare(name, out_a, out_b, "record, planned vs default")
        errs[name] = max(errs[name], err)
        lib = library_call(name, args, kw)
        emit(card, phase="kernels", name=name, case="record", knobs=kn,
             knobs_b=default_knobs(name),
             shape=[list(t.shape) for t in args
                    if isinstance(t, torch.Tensor)],
             max_abs_err=err,
             ms=time_ms(lambda: kfn(*args, **kw, **kn)),
             ms_b=time_ms(lambda: kfn(*args, **kw, **default_knobs(name))),
             plain_ms=time_ms(lambda: pfn(*args, **kw)),
             library_ms=time_ms(lib) if lib is not None else None)

    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{name}.cu",
             "replaces": REPLACES[name], "launches": counts[name],
             "max_abs_err": errs[name], "ms": rows[name]["ms"],
             "plain_ms": rows[name]["plain_ms"],
             "bound_ms": rows[name]["bound_ms"],
             "bound_by": rows[name]["bound_by"],
             "library_ms": rows[name]["library_ms"],
             "shape": rows[name]["shape"],
             **({"bf16_ms": ssd_bf16["ms"],
                 "bf16_bound_ms": ssd_bf16["bound_ms"],
                 "bf16_max_abs_err": ssd_bf16["max_abs_err"]}
                if name == "ssd_scan" else {})}
            for name in REPLACES], counts


def main() -> int:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell_worker = None
    try:
        from repro_torch.kernels import build

        card = card_line()
        print(card, flush=True)
        t0 = time.perf_counter()
        logs = build.build_all()
        emit(card, phase="build", seconds=time.perf_counter() - t0,
             kernels=list(build.SOURCES),
             ptxas={k: [ln.strip() for ln in v.splitlines()
                        if "Used" in ln or "spill" in ln]
                    for k, v in logs.items()})
        # phase 20(b) needs no card: it runs beside phases 2-19
        cell_worker = DryWorker("cell")

        G = boundary_groups(TOTAL_MS)
        shapes = sorted({7 * SMALL_MIXES, G * SMALL_MIXES,
                         7 * SCALE_MIXES, G * SCALE_MIXES})
        def probed(name, value):
            memory_probe(card, name)
            return value

        kern = probed("kernel", kernel_phase(card, shapes))
        small, _, flat_small = probed("sweep", sweep_phase(card))
        stacked, counts, flat_scale = probed("scale",
                                             scale_phase(card, small))
        record_knobs, full_knobs, budget = probed("plan", plan_phase(card))
        path_rows, path_counts = probed("kernels", kernels_phase(
            card, record_knobs, full_knobs, budget))
        launches_segment = segment_phase(card, stacked)
        del stacked
        memory_probe(card, "segment")
        launches_grid = probed("grid", grid_phase(card))
        launches_managers = probed("managers", managers_phase(card))
        probed("characterization", characterization_phase(card))
        launches_plant = probed("plant", plant_phase(card))
        launches_static = probed("static", static_phase(card))
        launches_stream = probed("stream", stream_phase(card))
        launches_models = probed("models", models_phase(card))
        launches_serve = probed("serve", serve_phase(card))
        launches_train, binding = probed("train", train_phase(card))
        launches_shard = probed("shard", sharding_phase(card))
        launches_mesh = probed("mesh", mesh_phase(card))
        launches_pipe = probed("pipe", pipe_phase(card))
        launches_dry = probed("dry", dry_phase(card, cell_worker))

        main_rec = kern["sweep_buckets"]
        paths = {k: v for k, v in kern.items() if isinstance(k, str)}
        kernels = [{
            "name": "lookahead_greedy",
            "route": "cuda",
            "source": "src/repro_torch/csrc/lookahead_greedy.cu",
            "replaces": "src/repro/kernels/lookahead_greedy/kernel.py:91",
            "launches": counts["lookahead_greedy"],
            "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": None,
            "shape": [main_rec["B"], N_APPS, TOTAL_UNITS + 1],
            "inputs": "the 4096-mix sweep's first boundary, in buckets",
            "ms_synthetic": kern[(G * SCALE_MIXES, False)]["ms"],
            "ms_one_table_boundary": kern["sweep_one_table"]["ms"],
            "paths_checked": {k: [v["B"], v["n"], v["U"]]
                              for k, v in paths.items()},
            "launches_kernel_path": path_counts["lookahead_greedy"],
            "launches_scale_one_table": flat_scale,
            "launches_sweep_32_one_table": flat_small,
            "launches_segment": launches_segment,
            "launches_grid": launches_grid,
            "launches_managers": launches_managers,
            "launches_plant": launches_plant,
            "launches_static": launches_static,
            "launches_stream": launches_stream,
            "launches_models": launches_models["lookahead_greedy"],
            "launches_serve": launches_serve["lookahead_greedy"],
            "launches_train_binding": binding["greedy_launches"],
        }, *path_rows]
        for row in kernels:
            row["launches_train"] = launches_train.get(row["name"], 0)
            row["launches_shard"] = launches_shard.get(row["name"], 0)
            row["launches_mesh"] = launches_mesh.get(row["name"], 0)
            row["launches_pipe"] = launches_pipe.get(row["name"], 0)
            row["launches_dry"] = launches_dry.get(row["name"], 0)
        emit(card, phase="done", seconds=time.perf_counter() - start)
        print(json.dumps({"kernels": kernels}), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if cell_worker is not None:
            cell_worker.stop()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dry-worker"]:
        sys.exit(dry_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
