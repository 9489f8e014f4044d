"""The reference's training-plant trajectories as data, for the port's
tests: ``tests/data/plant_golden.json``, written by
``tools/plant_golden.py`` (floats as ``float.hex``).  Imports neither
JAX nor the JAX package, so the card tests use it too."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "plant_golden.json"

FIELDS = ("kinds", "t_ms", "duration_ms", "cache_units", "bandwidth",
          "prefetch_on", "ipc", "queuing_delay_ns")
DTYPES = {"kinds": np.int32, "t_ms": np.float64, "duration_ms": np.float64,
          "cache_units": np.int64, "bandwidth": np.float64,
          "prefetch_on": bool, "ipc": np.float64,
          "queuing_delay_ns": np.float64}
FLOAT_FIELDS = tuple(f for f, t in DTYPES.items() if t is np.float64)
DISCRETE_FIELDS = tuple(f for f in FIELDS if f not in FLOAT_FIELDS)

#: Cases whose CPU runs take too long for the tier-1 run (the card's
#: smoke run holds them).
LONG_CASES = ("full_4000ms",)


def load() -> Dict[str, Tuple[dict, Dict[str, np.ndarray]]]:
    """{case: (arguments, {field: array})}."""
    data = json.loads(PATH.read_text())
    out = {}
    for name, case in data["cases"].items():
        fields = {}
        for f in FIELDS:
            v = case["golden"][f]
            if f in FLOAT_FIELDS:
                v = np.vectorize(float.fromhex, otypes=[np.float64])(
                    np.asarray(v, dtype=object))
            fields[f] = np.asarray(v, dtype=DTYPES[f])
        out[name] = (case["args"], fields)
    return out


def port_kwargs(args: dict) -> dict:
    """The keyword arguments of the port's ``run_fused_schedule`` /
    ``host_reference_run`` for one case (the model aside)."""
    from repro_torch.core.types import CBPParams, Mode, PrefetchMode

    return dict(
        n_clients=args["n_clients"], total_units=args["total_units"],
        total_bandwidth=args["total_bandwidth"], total_ms=args["total_ms"],
        params=CBPParams(**args["params"]),
        cache_mode=Mode(args.get("cache_mode", "dynamic")),
        bandwidth_mode=Mode(args.get("bandwidth_mode", "dynamic")),
        prefetch_mode=PrefetchMode(args.get("prefetch_mode", "dynamic")))


def plant_model(args: dict, device: str):
    """The port's ``(step_fn, step_model)`` for one case on ``device``."""
    from repro_torch.train.plant_model import make_stream_plant_model

    return make_stream_plant_model(
        args["n_clients"], args["total_units"], args["total_bandwidth"],
        seed=args["seed"], device=device)


def assert_bit_identical(got, want: Dict[str, np.ndarray], what: str = ""):
    """All eight fields equal, dtypes and shapes included."""
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), want[f],
                                      err_msg=f"{what} {f}", strict=True)


def assert_within(got, want: Dict[str, np.ndarray], rtol: float,
                  what: str = "") -> float:
    """Discrete fields equal, floats within ``rtol``; returns the largest
    relative difference of a float field."""
    for f in DISCRETE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), want[f],
                                      err_msg=f"{what} {f}", strict=True)
    worst = 0.0
    for f in FLOAT_FIELDS:
        g, w = getattr(got, f), want[f]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, f)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                   err_msg=f"{what} {f}")
        nz = w != 0
        if nz.any():
            worst = max(worst, float(np.max(np.abs(g[nz] - w[nz])
                                            / np.abs(w[nz]))))
    return worst
