"""Reference values from the JAX package for the port's tests.

The JAX package must run in float64 to be the reference, and the
installed JAX has no in-process ``enable_x64`` context: turning on the
global ``jax_enable_x64`` flag inside a test process would leak into the
JAX test files that share the worker.  So each ``tests/test_torch_*.py``
file computes its references once, in a subprocess started with
``JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu``, through a module-scoped fixture
(:func:`jax_reference`).  The subprocess draws the inputs from a seed with
numpy, runs the JAX functions and writes inputs and outputs to one
``.npz``; the test feeds the same inputs to the port.

Run as a script: ``python tests/_torch_jax_ref.py CASE OUT.npz``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"

#: Greedy cases: (kind, masked) over batches of (B, n, U+1) curves.
GREEDY_KINDS = ("concave", "nonmonotone", "flat")
GREEDY_SHAPES = ((8, 6, 48), (3, 16, 256))     # (B, n, U)

SWEEP_MIXES, SWEEP_MS, SWEEP_SEED = 4, 20.0, 1

#: ``run_sweep(param_grid=...)`` cases: (mixes, managers, total_ms, grid)
#: with each ``CBPParams`` as a dict of its fields.  "fig12" is the
#: reference test's case (two same-schedule params, one schedule-distinct;
#: a params-static manager); "decay" sweeps the decay constants; "rows"
#: gives its two same-schedule rows different values of all five per-row
#: tunables, over every manager.
GRID_CASES = {
    "fig12": (("w1", "w2"), ("equal on", "CBP", "CPpf"), 20.0,
              ({"min_bandwidth_allocation": 0.5},
               {"min_bandwidth_allocation": 1.0},
               {"reconfiguration_interval_ms": 5.0})),
    "decay": (("w1",), ("CBP",), 30.0,
              ({}, {"atd_decay": 0.9, "bandwidth_delay_decay": 0.2})),
    "rows": (("w3", "w4"), None, 20.0,
             ({"min_ways": 2, "speedup_threshold": 1.02,
               "min_bandwidth_allocation": 0.5, "atd_decay": 0.7,
               "bandwidth_delay_decay": 0.3},
              {"min_ways": 6, "speedup_threshold": 1.2,
               "min_bandwidth_allocation": 2.0, "atd_decay": 0.4,
               "bandwidth_delay_decay": 0.8})),
}

#: Grouped-greedy cases: (B, n, U, min_units, kind).  U = 2048 is the
#: reference planner's default budget (16 MiB / 8 KiB units), U = 28 an
#: H100 block's 232,448 bytes of shared memory.
PLANNER_GROUPS = ((4, 3, 2048, 2, "tiles"), (5, 6, 48, 1, "nonmonotone"),
                  (3, 3, 28, 2, "tiles"), (2, 16, 256, 4, "concave"))
#: Planner specs (the JAX key ``vmem_budget``; the port's ``budget_bytes``):
#: the kernel_blocks record's four, full-width shapes at the reference
#: default and at 232,448 bytes, and a prime / m < 8 query.
PLANNER_SPECS = (
    {"kernel": "cbp_matmul", "m": 512, "n": 512, "k": 512,
     "dtype_bytes": 4, "vmem_budget": 768 * 1024},
    {"kernel": "flash_attention", "seq_q": 512, "seq_kv": 512,
     "head_dim": 64, "dtype_bytes": 4, "vmem_budget": 768 * 1024},
    {"kernel": "flash_decode", "seq_kv": 2048, "head_dim": 64,
     "dtype_bytes": 4, "vmem_budget": 384 * 1024},
    {"kernel": "ssd_scan", "seq_len": 512, "state_dim": 32,
     "dtype_bytes": 4, "vmem_budget": 384 * 1024},
    {"kernel": "cbp_matmul", "m": 4096, "n": 12288, "k": 4096},
    {"kernel": "flash_attention", "seq_q": 4096, "seq_kv": 4096,
     "head_dim": 128},
    {"kernel": "flash_decode", "seq_kv": 8192, "head_dim": 128},
    {"kernel": "ssd_scan", "seq_len": 4096, "state_dim": 128,
     "dtype_bytes": 4},
    {"kernel": "cbp_matmul", "m": 4096, "n": 12288, "k": 4096,
     "vmem_budget": 232448},
    {"kernel": "flash_attention", "seq_q": 4096, "seq_kv": 4096,
     "head_dim": 128, "vmem_budget": 232448},
    {"kernel": "flash_decode", "seq_kv": 8192, "head_dim": 128,
     "vmem_budget": 232448},
    {"kernel": "ssd_scan", "seq_len": 4096, "state_dim": 128,
     "dtype_bytes": 4, "vmem_budget": 232448},
    {"kernel": "cbp_matmul", "m": 97, "n": 97, "k": 97,
     "vmem_budget": 262144},
    {"kernel": "cbp_matmul", "m": 6, "n": 512, "k": 512, "dtype_bytes": 4,
     "vmem_budget": 262144},
)


def jax_reference(case: str, tmp_path_factory) -> dict:
    """Run ``case`` in a float64 JAX subprocess; return its arrays."""
    out = tmp_path_factory.mktemp("jax_ref") / f"{case}.npz"
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, __file__, case, str(out)], env=env,
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference {case!r} failed:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with np.load(out) as data:
        return dict(data)


def greedy_curves(rng, B: int, n: int, U: int, kind: str) -> np.ndarray:
    u = np.arange(U + 1, dtype=np.float64)
    if kind == "concave":
        return (rng.uniform(0.0, 50.0, (B, n, 1))
                * (1.0 - np.exp(-u / rng.uniform(2.0, 40.0, (B, n, 1)))))
    if kind == "nonmonotone":
        return np.cumsum(rng.normal(0.0, 1.0, (B, n, U + 1)), axis=-1)
    return np.zeros((B, n, U + 1))


#: Greedy edge cases, shared by the CPU test against the JAX Pallas kernel
#: and the card test of the CUDA kernel: exact ties, cached best steps that
#: the shrinking balance invalidates, ``remaining < U``, all-inactive rows,
#: ``min_units`` 0 and ``n * min_units = U``, B = 1, B not a multiple of the
#: rows a thread block holds, and more than 32 clients.
GREEDY_EDGE_CASES = ("ties_linear", "ties_flat", "invalidated", "steps",
                     "remaining_lt_U", "all_inactive", "min_zero",
                     "min_full", "b1", "b_odd", "b_odd_wide", "n_over_32")


def _linear(slopes, U: int, offsets=None) -> np.ndarray:
    """(n, U+1) straight lines; slopes and offsets in quarters, so every
    marginal utility is exact and equal along a line."""
    u = np.arange(U + 1, dtype=np.float64)
    slopes = np.asarray(slopes, dtype=np.float64)[:, None]
    off = 0.0 if offsets is None else np.asarray(offsets, np.float64)[:, None]
    return off + slopes * u


def _ramp(slope: float, knee: int, tail: float, U: int) -> np.ndarray:
    """``slope`` per unit up to ``knee`` units, ``tail`` per unit after."""
    u = np.arange(U + 1, dtype=np.float64)
    return np.where(u <= knee, slope * u, slope * knee + tail * (u - knee))


def _jump(height: float, at: int, U: int) -> np.ndarray:
    """Flat, then ``height`` from ``at`` units on: the best step is k = at."""
    return np.where(np.arange(U + 1) >= at, height, 0.0)


def _steps(rng, B: int, n: int, U: int) -> np.ndarray:
    """Sparse integer jumps: large best steps and many exact ties."""
    jumps = ((rng.random((B, n, U)) < 0.08)
             * rng.integers(1, 20, (B, n, U))).astype(np.float64)
    return np.concatenate([np.zeros((B, n, 1)), np.cumsum(jumps, -1)], -1)


def greedy_edge_inputs(name: str):
    """``(curves (B, n, U+1) f64, min_units (B,) i32, active (B, n) i32,
    remaining (B,) i32, U)`` of one case of :data:`GREEDY_EDGE_CASES`;
    ``remaining`` is the capacity left after pinning the inactive clients,
    as CPpf passes it, unless the case sets it."""
    rng = np.random.default_rng(sum(map(ord, name)))
    active = remaining = None
    if name == "ties_linear":
        U = 48
        curves = np.stack([
            _linear([1, 1, 1, 1, 1, 1], U),
            _linear([0.5, 1, 1, 0.25, 1, 0.5], U),
            _linear([0.75, 0.75, 0.5, 0.75, 0.25, 0.75], U,
                    offsets=[3, 0, 1.5, -2, 0, 7]),
            np.stack([_ramp(1.0, 8, 0.5, U), _ramp(1.0, 8, 0.5, U),
                      _ramp(0.5, 40, 0.25, U), _ramp(1.0, 3, 0.5, U),
                      _linear([0.5], U)[0], _ramp(0.75, 10, 0.5, U)])])
        mins = np.full(4, 2)
    elif name == "ties_flat":
        U = 48
        flat = np.full((6, U + 1), 7.0)
        mixed = flat.copy()
        mixed[[1, 3, 5]] = _linear([0.5, 0.5, 0.5], U)
        pair = np.zeros((6, U + 1))
        pair[[1, 4]] = _linear([0.5, 0.5], U)
        curves = np.stack([flat, mixed, np.zeros((6, U + 1)), pair])
        mins = np.array([1, 1, 0, 3])
    elif name == "invalidated":
        U = 48
        curves = np.stack([
            np.stack([_jump(100.0, 40, U), _ramp(3.0, 20, 0.125, U),
                      _ramp(2.5, 5, 0.0, U)]),
            np.stack([_jump(90.0, 30, U), _ramp(3.5, 24, 0.25, U),
                      _ramp(3.25, 10, 0.0, U)]),
            np.stack([_ramp(2.0, 12, 0.0, U), _jump(45.0, 15, U),
                      _jump(47.0, 16, U)])])
        mins = np.zeros(3)
    elif name == "steps":
        U = 64
        curves = _steps(rng, 6, 8, U)
        mins = rng.integers(0, 3, 6)
    elif name == "remaining_lt_U":
        U = 64
        curves = greedy_curves(rng, 6, 8, U, "concave")
        mins = np.full(6, 2)
        active = rng.integers(0, 2, (6, 8))
        remaining = rng.integers(17, U, 6)
    elif name == "all_inactive":
        U = 64
        curves = greedy_curves(rng, 4, 8, U, "nonmonotone")
        mins = np.full(4, 2)
        active = rng.integers(0, 2, (4, 8))
        active[[0, 2]] = 0
    elif name == "min_zero":
        U = 64
        curves = np.concatenate([greedy_curves(rng, 2, 8, U, "nonmonotone"),
                                 _steps(rng, 2, 8, U)])
        mins = np.zeros(4)
    elif name == "min_full":
        U = 64
        curves = greedy_curves(rng, 3, 8, U, "concave")
        mins = np.array([8, 8, 7])
    elif name == "b1":
        U = 256
        curves = greedy_curves(rng, 1, 16, U, "concave")
        mins = np.full(1, 4)
    elif name == "b_odd":
        U = 40
        curves = greedy_curves(rng, 13, 5, U, "nonmonotone")
        mins = np.ones(13)
    elif name == "b_odd_wide":
        U = 256
        curves = np.concatenate([greedy_curves(rng, 5, 16, U, "concave"),
                                 greedy_curves(rng, 5, 16, U, "nonmonotone")])
        mins = np.full(10, 4)
        active = rng.integers(0, 2, (10, 16))
    elif name == "n_over_32":
        U = 120
        curves = np.concatenate([greedy_curves(rng, 2, 40, U, "nonmonotone"),
                                 _steps(rng, 1, 40, U)])
        mins = np.ones(3)
    else:
        raise KeyError(name)
    B, n, _ = curves.shape
    mins = np.asarray(mins, dtype=np.int32)
    active = (np.ones((B, n)) if active is None else active).astype(np.int32)
    if remaining is None:
        remaining = U - mins * (n - active.sum(-1))
    return (curves.astype(np.float64), mins, active,
            np.asarray(remaining, dtype=np.int32), U)


# --------------------------------------------------------------------- #
# cases (run inside the float64 subprocess)
# --------------------------------------------------------------------- #

def _case_lookahead(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core import cache_controller_jax as ccj
    from repro.kernels.lookahead_greedy import ops

    assert jax.config.jax_enable_x64
    rng = np.random.default_rng(11)
    for B, n, U in GREEDY_SHAPES:
        for kind in GREEDY_KINDS:
            for masked in (False, True):
                key = f"{kind}_{int(masked)}_{B}x{n}x{U}"
                curves = greedy_curves(rng, B, n, U, kind)
                mins = rng.integers(0, U // n // 2 + 1, B).astype(np.int32)
                if masked:
                    active = rng.integers(0, 2, (B, n)).astype(bool)
                    active[0] = False            # an all-inactive row
                else:
                    active = np.ones((B, n), dtype=bool)
                remaining = (U - mins * (n - active.sum(-1))).astype(
                    np.int32)
                alloc, bal = ops.lookahead_greedy(
                    jnp.asarray(curves), jnp.asarray(mins),
                    jnp.asarray(active.astype(np.int32)),
                    jnp.asarray(remaining), total_units=U)
                full = ccj.lookahead_allocate_masked(
                    curves, U, mins, active, backend="pallas")
                out.update({
                    f"{key}_curves": curves, f"{key}_mins": mins,
                    f"{key}_active": active, f"{key}_remaining": remaining,
                    f"{key}_alloc": np.asarray(alloc),
                    f"{key}_balance": np.asarray(bal),
                    f"{key}_full": full})
    for name in GREEDY_EDGE_CASES:
        curves, mins, active, remaining, U = greedy_edge_inputs(name)
        alloc, bal = ops.lookahead_greedy(
            jnp.asarray(curves), jnp.asarray(mins), jnp.asarray(active),
            jnp.asarray(remaining), total_units=U)
        out[f"edge_{name}_alloc"] = np.asarray(alloc)
        out[f"edge_{name}_balance"] = np.asarray(bal)


def memsys_inputs(rng):
    """Two-mix app stack and random allocations for the model cases."""
    from repro.sim.apps import stack_mixes
    from repro.sim.workloads import random_mixes

    apps = stack_mixes(random_mixes(2, 16, seed=5))
    M, n = apps.cpi_base.shape
    units = rng.integers(4, 40, (M, n)).astype(np.float64)
    bw = rng.uniform(1.0, 8.0, (M, n))
    pf = rng.integers(0, 2, (M, n)).astype(np.float64)
    return apps, units, bw, pf


#: (cache_partitioned, bandwidth_partitioned, bandwidth_banks) of the
#: static-flag evaluate cases.
EVAL_FLAGS = ((True, True, 1), (True, False, 1), (False, True, 1),
              (False, False, 1), (True, True, 4), (False, True, 4))


def rowflag_inputs(apps, units, bw, pf):
    """Six rows = the two mixes under three per-row flag settings."""
    tile = {f: np.tile(getattr(apps, f), (3, 1))
            for f in ("cpi_base", "apki", "mpki_min_alloc", "mpki_floor",
                      "ws_units", "mlp", "wb_frac", "pf_cov", "pf_acc",
                      "pf_hide", "pf_pollution")}
    cache_part = np.array([True, True, False, False, True, False])[:, None]
    bw_part = np.array([True, False, True, False, True, True])[:, None]
    banks = np.array([1.0, 1.0, 4.0, 1.0, 4.0, 1.0])[:, None]
    return (tile, np.tile(units, (3, 1)), np.tile(bw, (3, 1)),
            np.tile(pf, (3, 1)), cache_part, bw_part, banks)


def _case_memsys(out: dict) -> None:
    import jax.numpy as jnp

    from repro.sim import memsys_jax

    rng = np.random.default_rng(3)
    apps, units, bw, pf = memsys_inputs(rng)
    for cp, bp, banks in EVAL_FLAGS:
        ss = memsys_jax.evaluate(
            apps, units, bw, pf, cache_partitioned=cp,
            bandwidth_partitioned=bp, bandwidth_banks=banks)
        for f in ("ipc", "queuing_delay_ns", "traffic_gbps", "mpki",
                  "exposed_mpki", "occupancy_units"):
            out[f"eval_{int(cp)}{int(bp)}{banks}_{f}"] = np.asarray(
                getattr(ss, f))
    tile, u6, b6, p6, cpart, bpart, banks = rowflag_inputs(
        apps, units, bw, pf)
    params = {k: jnp.asarray(v) for k, v in tile.items()}
    for max_banks in (1, 4):
        res = memsys_jax._evaluate_rowflags(
            params, jnp.asarray(u6), jnp.asarray(b6), jnp.asarray(p6),
            jnp.asarray(256.0), jnp.asarray(64.0), jnp.asarray(0.0),
            jnp.asarray(cpart), jnp.asarray(bpart), iters=60,
            bandwidth_banks=jnp.asarray(banks) if max_banks > 1 else None,
            max_banks=max_banks)
        out[f"rowflags_{max_banks}_ipc"] = np.asarray(res[0])
        out[f"rowflags_{max_banks}_q"] = np.asarray(res[1])
    ipc = np.asarray(memsys_jax.evaluate(apps, units, bw, pf).ipc)
    out["curves"] = np.asarray(
        memsys_jax.utility_curves(apps, pf, ipc, 256, duration_ms=0.5))
    out["curves_ipc"] = ipc


def controller_inputs(rng):
    B, n, U = 6, 16, 64
    delay = rng.uniform(0.0, 50.0, (B, n))
    delay[0] = 0.0                                  # nobody queued
    min_alloc = rng.uniform(0.5, 3.0, (B, 1))
    perf_with = rng.uniform(0.1, 2.0, (B, n))
    perf_without = rng.uniform(0.1, 2.0, (B, n))
    perf_without[1, :4] = 0.0
    thr = rng.uniform(1.0, 1.2, (B, 1))
    curves = np.cumsum(rng.uniform(0.0, 5.0, (B, n, U + 1)), axis=-1)
    slowdown = rng.uniform(0.8, 1.5, (B, n))
    min_ways = rng.integers(1, 4, (B, 1)).astype(np.int32)
    bound = np.full((B, 1), 1.05)
    gain = np.full((B, 1), 8.0)
    return dict(delay=delay, min_alloc=min_alloc, perf_with=perf_with,
                perf_without=perf_without, thr=thr, curves=curves,
                slowdown=slowdown, min_ways=min_ways, bound=bound,
                gain=gain, U=np.int64(U))


def _case_controllers(out: dict) -> None:
    import jax.numpy as jnp

    from repro.core.bandwidth_controller import allocate_bandwidth_jax
    from repro.core.prefetch_controller import throttle_decision_jax
    from repro.sim import policies

    inp = controller_inputs(np.random.default_rng(7))
    out.update(inp)
    U = int(inp["U"])
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    out["bw_scalar"] = np.asarray(allocate_bandwidth_jax(
        j["delay"], 64.0, 1.0))
    out["bw_rows"] = np.asarray(allocate_bandwidth_jax(
        j["delay"], 64.0, j["min_alloc"]))
    out["thr_scalar"] = np.asarray(throttle_decision_jax(
        j["perf_with"], j["perf_without"], 1.05))
    out["thr_rows"] = np.asarray(throttle_decision_jax(
        j["perf_with"], j["perf_without"], j["thr"]))
    units, bw = policies.auction_allocate_jax(
        j["curves"], j["delay"], min_ways=j["min_ways"], total_units=U,
        min_bandwidth=j["min_alloc"], total_bandwidth=64.0)
    out["auction_units"], out["auction_bw"] = np.asarray(units), np.asarray(bw)
    units, bw = policies.qos_allocate_jax(
        j["curves"], j["delay"], j["slowdown"], min_ways=j["min_ways"],
        total_units=U, min_bandwidth=j["min_alloc"], total_bandwidth=64.0,
        bound=j["bound"], gain=j["gain"])
    out["qos_units"], out["qos_bw"] = np.asarray(units), np.asarray(bw)
    target = np.random.default_rng(8).dirichlet(np.ones(16), 6) * U
    out["lrr_target"] = target
    out["lrr"] = np.asarray(policies.largest_remainder_round_jax(
        jnp.asarray(target), U))


def _case_sweep(out: dict) -> None:
    from repro.sim import random_mixes, run_sweep

    res = run_sweep(random_mixes(SWEEP_MIXES, 16, seed=SWEEP_SEED),
                    total_ms=SWEEP_MS)
    out["baseline_ipc"] = res.baseline_ipc
    for name in res.manager_names:
        alloc = res.final_alloc[name]
        out[f"{name}|ipc"] = res.ipc[name]
        out[f"{name}|units"] = np.asarray(alloc.cache_units)
        out[f"{name}|bw"] = np.asarray(alloc.bandwidth)
        out[f"{name}|pf"] = np.asarray(alloc.prefetch_on)
        out[f"{name}|geomean"] = np.float64(res.geomean_speedup(name))


def _case_grid(out: dict) -> None:
    from repro.core.types import CBPParams
    from repro.sim import WORKLOADS, run_sweep

    for case, (mixes, names, total_ms, grid) in GRID_CASES.items():
        res = run_sweep([WORKLOADS[w] for w in mixes], managers=names,
                        total_ms=total_ms,
                        param_grid=[CBPParams(**p) for p in grid])
        out[f"{case}|baseline_ipc"] = res.baseline_ipc
        for name in res.manager_names:
            alloc = res.final_alloc[name]
            out[f"{case}|{name}|ipc"] = res.ipc[name]
            out[f"{case}|{name}|units"] = np.asarray(alloc.cache_units)
            out[f"{case}|{name}|bw"] = np.asarray(alloc.bandwidth)
            out[f"{case}|{name}|pf"] = np.asarray(alloc.prefetch_on)
            out[f"{case}|{name}|geomean"] = np.asarray(
                res.geomean_speedup(name))


def planner_curves(rng, B: int, n: int, U: int, kind: str) -> np.ndarray:
    """Tile-utility curves of random matmul shapes (``kind == "tiles"``,
    n = 3) or random greedy curves."""
    if kind != "tiles":
        return greedy_curves(rng, B, n, U, kind)
    from repro.runtime.cbp_runtime import _tile_utility_curves

    dims = rng.integers(1, 9, (B, 3)) * 512
    return np.stack([_tile_utility_curves(m, nn, k, 2, 8192, U)
                     for m, nn, k in dims])


def _case_planner(out: dict) -> None:
    from repro.core import cache_controller_jax as ccj
    from repro.runtime.cbp_runtime import plan_kernel_blocks

    rng = np.random.default_rng(13)
    groups = [planner_curves(rng, B, n, U, kind)
              for B, n, U, _m, kind in PLANNER_GROUPS]
    mins = [m for _B, _n, _U, m, _k in PLANNER_GROUPS]
    allocs = ccj.lookahead_allocate_grouped(
        groups, [U for _B, _n, U, _m, _k in PLANNER_GROUPS], min_units=mins,
        backend="jax")
    for i, (curves, alloc) in enumerate(zip(groups, allocs)):
        out[f"group{i}_curves"], out[f"group{i}_alloc"] = curves, alloc
    knobs = plan_kernel_blocks([dict(s) for s in PLANNER_SPECS],
                               allocator_backend="jax")
    for i, kn in enumerate(knobs):
        out[f"spec{i}_knobs"] = np.array(list(kn.values()))


def _case_plant(out: dict) -> None:
    """The fused Fig. 8 knob schedule of the training plant
    (``repro.runtime.plant_jax.run_fused_schedule``) for every case of
    ``tests/data/plant_golden.json`` but the long ones."""
    from _plant_golden import FIELDS, LONG_CASES, load
    from repro.core.types import CBPParams, Mode, PrefetchMode
    from repro.runtime.plant_jax import run_fused_schedule
    from repro.train.plant_model import make_stream_plant_model

    for name, (args, _golden) in load().items():
        if name in LONG_CASES:
            continue
        _step_fn, step_model = make_stream_plant_model(
            args["n_clients"], args["total_units"], args["total_bandwidth"],
            seed=args["seed"])
        res = run_fused_schedule(
            step_model, n_clients=args["n_clients"],
            total_units=args["total_units"],
            total_bandwidth=args["total_bandwidth"],
            total_ms=args["total_ms"], params=CBPParams(**args["params"]),
            cache_mode=Mode(args.get("cache_mode", "dynamic")),
            bandwidth_mode=Mode(args.get("bandwidth_mode", "dynamic")),
            prefetch_mode=PrefetchMode(args.get("prefetch_mode", "dynamic")))
        for f in FIELDS:
            out[f"{name}|{f}"] = getattr(res, f)


#: ``tests/test_static_search.py::test_batched_matches_numpy_backend``'s
#: cases: (apps per workload, seed) of ``random_workloads(4, ...)``, k = 3.
STATIC_CASES = ((2, 3), (3, 5))


def _case_static_search(out: dict) -> None:
    """The JAX backend of the Fig. 5 static search
    (``repro.sim.static_search.search_static(backend="jax")``) on
    :data:`STATIC_CASES`."""
    from repro.sim.static_search import search_static
    from repro.sim.workloads import random_workloads

    for n_apps, seed in STATIC_CASES:
        res = search_static(random_workloads(4, n_apps, seed=seed), k=3,
                            backend="jax")
        out[f"{n_apps}_{seed}|baseline_ipc"] = res.baseline_ipc
        for fam in res.family_names:
            out[f"{n_apps}_{seed}|{fam}|topk_ws"] = res.topk_ws[fam]
            out[f"{n_apps}_{seed}|{fam}|topk_index"] = res.topk_index[fam]


def _case_stream(out: dict) -> None:
    """The reference's streaming sweep in float64
    (``tools/stream_golden.py::reference_run``) on the golden's ``tests``
    case, healthy and under its fault plan: the aggregate tree and the
    quarantined chunks of each run.  Also the checkpoints of the healthy
    stream killed at chunk 2 (every chunk checkpointed), written next to
    the output file; ``ckpt_dir`` names their directory."""
    import importlib.util

    from repro.runtime.faultinject import FaultPlan, InjectedProcessKill
    from repro.sim import stream_sweep, workloads

    path = SRC.parent / "tools" / "stream_golden.py"
    spec = importlib.util.spec_from_file_location("stream_golden", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args, plans = tool.CASES["tests"]
    for run, plan in plans.items():
        report = tool.reference_run(args, plan)
        for key, a in report.aggregates.to_tree().items():
            out[f"{run}|{key}"] = a
        out[f"{run}|quarantined"] = np.array(
            [c for c, _ in report.quarantined], dtype=np.int64)
        out[f"{run}|retries"] = np.array(report.retries)
    ckpt = Path(sys.argv[2]).resolve().parent / "stream_ck"
    try:
        stream_sweep.run_stream(
            tool.stream_config(args, stream_sweep, workloads,
                               checkpoint_dir=str(ckpt),
                               checkpoint_every=1),
            fault_plan=FaultPlan.single("kill", 2))
    except InjectedProcessKill:
        out["ckpt_dir"] = np.array(str(ckpt))


CASES = {"lookahead": _case_lookahead, "memsys": _case_memsys,
         "controllers": _case_controllers, "sweep": _case_sweep,
         "planner": _case_planner, "grid": _case_grid, "plant": _case_plant,
         "static_search": _case_static_search, "stream": _case_stream}


if __name__ == "__main__":
    case, path = sys.argv[1], sys.argv[2]
    arrays: dict = {}
    CASES[case](arrays)
    np.savez(path, **arrays)
