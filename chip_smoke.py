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
             on the very inputs the 4096-mix sweep hands the kernel at its
             first boundary (captured from the sweep, which stops there):
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

Phases 3 and 4 each add one profiled sweep for the device time by kernel
and the card's busy share (device time over the unprofiled warm wall).

Its second path is the paper's kernel-level binding: the UCP block
planner (``repro_torch.runtime.cbp_runtime.plan_kernel_blocks``) splits an
on-chip memory budget among a kernel's tiles, and the four kernels run
under the planned knobs:

5. plan    — the planner on the card for the four specs of the committed
             ``results/bench/kernel_blocks.json`` record (its knobs must
             equal the record's) and for full-width specs at a budget of
             the card's shared memory per block; every plan must equal the
             port's CPU run, with one greedy launch per capacity group.
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
bound; the greedy's at the sweep's own boundary inputs).  Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}`` on success.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

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


def sweep_boundary_inputs():
    """The greedy's inputs at the first boundary of the 4096-mix sweep:
    ``timeline.run_timelines`` hands them to ``lookahead_masked_traced``,
    which calls the kernel's wrapper through ``core.cache_controller``.  A
    stand-in wrapper there keeps a copy of the first call's arguments and
    stops the sweep; returns ``(curves, min_units, active, remaining)``."""
    from repro_torch.core import cache_controller
    from repro_torch.sim import random_mixes, run_sweep

    class Captured(Exception):
        pass

    got = {}

    def capture(*args, total_units):
        check(total_units == TOTAL_UNITS,
              f"the sweep's greedy has U = {total_units}")
        got["args"] = tuple(t.clone() for t in args)
        raise Captured

    real = cache_controller.lookahead_greedy
    cache_controller.lookahead_greedy = capture
    try:
        run_sweep(random_mixes(SCALE_MIXES, N_APPS, seed=SEED),
                  total_ms=TOTAL_MS)
    except Captured:
        pass
    finally:
        cache_controller.lookahead_greedy = real
    check("args" in got, "the 4096-mix sweep never called the greedy")
    return got["args"]


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
    the sweep's own boundary inputs; returns the measurements per (B,
    masked), the latter under the key "sweep"."""
    import torch
    from repro_torch.kernels.lookahead_greedy import (
        LAUNCHES,
        lookahead_greedy,
        lookahead_greedy_plain,
    )

    U = TOTAL_UNITS
    out = {}

    def cases():
        for B in shapes:
            for masked in (False, True):
                yield (B, masked), greedy_inputs(B, masked, seed=B + masked)
        yield "sweep", sweep_boundary_inputs()

    for key, args in cases():
        B = args[0].shape[0]
        masked = key == "sweep" or key[1]
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
              f"lookahead_greedy != plain at {key} (B={B}): "
              f"{int((alloc != alloc_p).any(1).sum())} rows differ")
        lookahead_greedy(*args, total_units=U)          # warm-up
        ms = cuda_ms(lambda: lookahead_greedy(*args, total_units=U), 20)
        n_bytes, n_ops = greedy_bound(args, U)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP64_OPS_PER_S * 1e3
        rec = {"inputs": "sweep boundary" if key == "sweep"
               else "synthetic",
               "B": B, "masked": masked, "n": N_APPS, "U": U,
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
        del alloc, bal, alloc_p, bal_p
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
    prof = profile_sweep(mixes)
    emit(card, phase="sweep", mixes=SMALL_MIXES, managers=len(got),
         total_ms=TOTAL_MS, warm_wall_s=warm_s, cold_wall_s=cold_s,
         fused_wall_s=fused_s, cpu_port_wall_s=cpu_s,
         launches=counts, geomeans=got,
         max_rel_diff_vs_cpu=worst, stacked_equals_fused=True,
         device_busy_share=(prof["device_s"] / warm_s
                            if prof["device_s"] is not None else None),
         profile=prof)
    return gpu, counts


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
    head = type(res)(
        manager_names=res.manager_names, mixes=res.mixes[:SMALL_MIXES],
        ipc={k: v[:SMALL_MIXES] for k, v in res.ipc.items()},
        final_alloc={k: type(a)(
            cache_units=a.cache_units[:SMALL_MIXES],
            bandwidth=a.bandwidth[:SMALL_MIXES],
            prefetch_on=a.prefetch_on[:SMALL_MIXES])
            for k, a in res.final_alloc.items()},
        baseline_ipc=res.baseline_ipc[:SMALL_MIXES])
    worst = compare_sweeps(head, small, exact_floats=False,
                           what="scale sweep's first 32 mixes vs phase 3")

    prof = profile_sweep(mixes)
    greedy_s = prof["greedy_device_s"]
    emit(card, phase="scale", mixes=SCALE_MIXES, managers=len(res.ipc),
         rows=len(res.ipc) * SCALE_MIXES, total_ms=TOTAL_MS,
         warm_wall_s=warm_s, cold_wall_s=cold_s,
         mixes_per_s=SCALE_MIXES / warm_s, launches=counts,
         peak_device_gb=peak_gb,
         kernel_share_of_warm_wall=(greedy_s / warm_s
                                    if greedy_s is not None else None),
         greedy_ms_per_launch=(greedy_s * 1e3 / counts["lookahead_greedy"]
                               if greedy_s is not None else None),
         device_busy_share=(prof["device_s"] / warm_s
                            if prof["device_s"] is not None else None),
         profile=prof, geomeans=res.summary(),
         max_rel_diff_head_vs_phase3=worst)
    return counts


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
    emit(card, phase="plan", budget_bytes=budget,
         record_knobs=plans["record"], full_knobs=plans["full"],
         greedy_launches=launches)
    return plans["record"], plans["full"], budget


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
        small, _ = sweep_phase(card)
        counts = scale_phase(card, small)
        record_knobs, full_knobs, budget = plan_phase(card)
        path_rows, path_counts = kernels_phase(card, record_knobs,
                                               full_knobs, budget)

        main_rec = kern["sweep"]
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
            "inputs": "the 4096-mix sweep's first boundary",
            "ms_synthetic": kern[(G * SCALE_MIXES, False)]["ms"],
            "launches_kernel_path": path_counts["lookahead_greedy"],
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
