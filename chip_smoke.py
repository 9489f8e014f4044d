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
             concave, nonmonotone and flat curves; plain and masked):
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

Every phase prints one JSON line with the card's name and power limit.
Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}`` on success.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

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
    """Compare and time the kernel at each batch size in ``shapes``;
    returns the measurements per (B, masked)."""
    import torch
    from repro_torch.kernels.lookahead_greedy import (
        LAUNCHES,
        lookahead_greedy,
        lookahead_greedy_plain,
    )

    U = TOTAL_UNITS
    out = {}
    for B in shapes:
        for masked in (False, True):
            launches0 = LAUNCHES.count
            args = greedy_inputs(B, masked, seed=B + masked)
            alloc, bal = lookahead_greedy(*args, total_units=U)
            torch.cuda.synchronize()
            work = {}
            alloc_p, bal_p = lookahead_greedy_plain(*args, total_units=U,
                                                    work=work)
            torch.cuda.synchronize()
            err = max(int((alloc - alloc_p).abs().max()),
                      int((bal - bal_p).abs().max()))
            check(torch.equal(alloc, alloc_p) and torch.equal(bal, bal_p),
                  f"lookahead_greedy != plain at B={B} masked={masked}: "
                  f"{int((alloc != alloc_p).any(1).sum())} rows differ")
            lookahead_greedy(*args, total_units=U)          # warm-up
            ms = cuda_ms(lambda: lookahead_greedy(*args, total_units=U), 20)
            plain_ms = cuda_ms(
                lambda: lookahead_greedy_plain(*args, total_units=U), 1)
            curves, mins, active, rem = args
            n_bytes = (curves.numel() * 8 + 4 * (mins.numel() + rem.numel()
                       + active.numel() + alloc.numel() + bal.numel()))
            n_ops = 2 * work["candidates"]   # one f64 sub + one div each
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP64_OPS_PER_S * 1e3
            rec = {"B": B, "masked": masked, "n": N_APPS, "U": U,
                   "launches": LAUNCHES.count - launches0,
                   "exact": True, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "trips": work["trips"],
                   "candidates": work["candidates"], "bytes": n_bytes,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None,
                   "library_note": "no single PyTorch call computes the "
                                   "Lookahead greedy"}
            emit(card, phase="kernel", name="lookahead_greedy", **rec)
            out[(B, masked)] = rec
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


def main() -> int:
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
             ptxas={k: [ln for ln in v.splitlines() if "Used" in ln]
                    for k, v in logs.items()})

        G = boundary_groups(TOTAL_MS)
        shapes = sorted({7 * SMALL_MIXES, G * SMALL_MIXES,
                         7 * SCALE_MIXES, G * SCALE_MIXES})
        kern = kernel_phase(card, shapes)
        small, _ = sweep_phase(card)
        counts = scale_phase(card, small)

        main_rec = kern[(G * SCALE_MIXES, False)]
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
            "shape": [G * SCALE_MIXES, N_APPS, TOTAL_UNITS + 1],
        }]
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
