#!/usr/bin/env python3
"""Write the reference's training-plant trajectories as data.

Runs the JAX package's host golden for the training-loop binding,
``repro.runtime.plant_jax.host_reference_run`` (the numpy
``CBPCoordinator`` over ``TrainingPlant`` with the numpy ``step_fn`` of
``repro.train.plant_model``), at every size and knob mode the port's
plant is held to, and writes ``tests/data/plant_golden.json``: per case
its arguments and the eight trajectory fields, floats as ``float.hex``
so that every bit survives.  The cases are the ones of
``tests/test_plant_jax.py`` (the base case, its four knob modes, three
shapes, the all-sampling boundary schedule), both shapes of
``benchmarks/runtime_bench.py``, that benchmark's full shape at a
4,000 ms horizon, and the base schedule under a second set of params.

    PYTHONPATH=src python tools/plant_golden.py

(``tests/test_torch_plant.py`` regenerates it in-process and compares.)

The golden path is numpy only; it needs no float64 JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "tests" / "data" / "plant_golden.json"

FIELDS = ("kinds", "t_ms", "duration_ms", "cache_units", "bandwidth",
          "prefetch_on", "ipc", "queuing_delay_ns")
FLOAT_FIELDS = ("t_ms", "duration_ms", "bandwidth", "ipc",
                "queuing_delay_ns")

_BASE = {"n_clients": 4, "total_units": 48, "total_bandwidth": 64.0,
         "total_ms": 60.0, "seed": 0}
_BASE_PARAMS = {"reconfiguration_interval_ms": 10.0, "min_ways": 2,
                "min_bandwidth_allocation": 2.0}
_FULL = {"n_clients": 12, "total_units": 96, "total_bandwidth": 128.0,
         "total_ms": 400.0, "seed": 0}
_FULL_PARAMS = {"reconfiguration_interval_ms": 5.0, "min_ways": 2,
                "min_bandwidth_allocation": 1.0}


def _shape(seed, n, units, bw, total_ms, interval):
    return {"n_clients": n, "total_units": units, "total_bandwidth": bw,
            "total_ms": total_ms, "seed": seed,
            "params": {"reconfiguration_interval_ms": interval,
                       "min_ways": 2, "min_bandwidth_allocation": 1.0}}


#: name -> arguments: the plant (n_clients, total_units, total_bandwidth,
#: seed), the horizon, the CBPParams fields, and the knob modes by value
#: (default "dynamic").
CASES = {
    "base": {**_BASE, "params": _BASE_PARAMS},
    "cache_equal": {**_BASE, "params": _BASE_PARAMS, "cache_mode": "equal"},
    "bandwidth_equal": {**_BASE, "params": _BASE_PARAMS,
                        "bandwidth_mode": "equal"},
    "prefetch_on": {**_BASE, "params": _BASE_PARAMS, "prefetch_mode": "on"},
    "prefetch_off": {**_BASE, "params": _BASE_PARAMS,
                     "prefetch_mode": "off"},
    "shape_seed3": _shape(3, 6, 64, 96.0, 85.0, 7.0),
    "shape_seed7": _shape(7, 12, 96, 128.0, 45.0, 5.0),
    "shape_seed11": _shape(11, 5, 40, 80.0, 400.0, 13.0),
    "boundary": {**_BASE, "total_ms": 30.0,
                 "params": {"reconfiguration_interval_ms": 1.0,
                            "prefetch_sampling_period_ms": 0.5,
                            "min_ways": 2, "min_bandwidth_allocation": 2.0}},
    # The base schedule under other values of every per-run scalar.
    "base_params2": {**_BASE, "params": {
        **_BASE_PARAMS, "min_ways": 3, "min_bandwidth_allocation": 1.0,
        "speedup_threshold": 1.02, "atd_decay": 0.7,
        "bandwidth_delay_decay": 0.3}},
    "full": {**_FULL, "params": _FULL_PARAMS},
    "full_4000ms": {**_FULL, "total_ms": 4000.0, "params": _FULL_PARAMS},
}


def reference_run(args: dict):
    """The reference's host golden for one case's arguments."""
    from repro.core.types import CBPParams, Mode, PrefetchMode
    from repro.runtime.plant_jax import host_reference_run
    from repro.train.plant_model import make_stream_plant_model

    step_fn, _ = make_stream_plant_model(
        args["n_clients"], args["total_units"], args["total_bandwidth"],
        seed=args["seed"])
    return host_reference_run(
        step_fn, n_clients=args["n_clients"],
        total_units=args["total_units"],
        total_bandwidth=args["total_bandwidth"],
        total_ms=args["total_ms"], params=CBPParams(**args["params"]),
        cache_mode=Mode(args.get("cache_mode", "dynamic")),
        bandwidth_mode=Mode(args.get("bandwidth_mode", "dynamic")),
        prefetch_mode=PrefetchMode(args.get("prefetch_mode", "dynamic")))


def encode(res) -> dict:
    """The eight fields as JSON: floats as ``float.hex``."""
    out = {}
    for f in FIELDS:
        a = getattr(res, f)
        if f in FLOAT_FIELDS:
            out[f] = np.vectorize(float.hex, otypes=[object])(a).tolist()
        else:
            out[f] = a.tolist()
    return out


def golden() -> dict:
    return {"source": "repro.runtime.plant_jax.host_reference_run with "
                      "repro.train.plant_model.make_stream_plant_model's "
                      "step_fn (tools/plant_golden.py)",
            "fields": list(FIELDS),
            "cases": {name: {"args": args, "golden": encode(
                reference_run(args))} for name, args in CASES.items()}}


def dumps(data: dict) -> str:
    return json.dumps(data, separators=(",", ":")) + "\n"


def main() -> int:
    text = dumps(golden())
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(text)
    print(f"wrote {PATH} ({len(text)} bytes, {len(CASES)} cases)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
