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
             training plant's first boundary (B=1, n=12, U=96) and the
             streaming sweep's first chunk at full width (B=512, n=16):
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
launches on every path and the shapes of every path's inputs it was held
to).  Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}`` on success.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import inspect
import json
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


def profile_sweep(mixes) -> dict:
    """One extra, profiled sweep: the device time of every CUDA kernel
    (and copy) it ran, summed once each, the greedy kernel's part, and the
    kernels that took the most.  Kernel durations are device-side, so they
    hold for the unprofiled run; the profiled wall does not (tracing slows
    the host).  Values are None where the profiler saw no device events."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import run_sweep

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_sweep(mixes, total_ms=TOTAL_MS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e6
    device_s = sum(by_name.values())
    greedy_s = sum(v for k, v in by_name.items() if "lookahead_greedy" in k)
    return {"profiled_wall_s": wall,
            "device_events": len(dev),
            "device_s": device_s if dev else None,
            "greedy_device_s": greedy_s if dev else None,
            "top_device_s": [[k, v] for k, v in by_name.most_common(5)]}


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

        G = boundary_groups(TOTAL_MS)
        shapes = sorted({7 * SMALL_MIXES, G * SMALL_MIXES,
                         7 * SCALE_MIXES, G * SCALE_MIXES})
        kern = kernel_phase(card, shapes)
        small, _, flat_small = sweep_phase(card)
        stacked, counts, flat_scale = scale_phase(card, small)
        record_knobs, full_knobs, budget = plan_phase(card)
        path_rows, path_counts = kernels_phase(card, record_knobs,
                                               full_knobs, budget)
        launches_segment = segment_phase(card, stacked)
        del stacked
        launches_grid = grid_phase(card)
        launches_managers = managers_phase(card)
        characterization_phase(card)
        launches_plant = plant_phase(card)
        launches_static = static_phase(card)
        launches_stream = stream_phase(card)

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
        }, *path_rows]
        emit(card, phase="done", seconds=time.perf_counter() - start)
        print(json.dumps({"kernels": kernels}), flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
