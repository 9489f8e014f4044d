#!/usr/bin/env python3
"""Write the reference's streaming sweeps as data.

Runs the JAX package's streaming sweep,
``repro.sim.stream_sweep.run_stream``, in float64 on the CPU on the
configurations the port's stream is held to, and writes
``tests/data/stream_golden.json``: per case its configuration and
fingerprint, and per run (healthy, and under the kill-free fault plan
where the case has one) the aggregate tree (floats as ``float.hex``, so
that every bit survives), the report's rounded fields and the quarantined
chunks.  The cases:

- ``tests``: ``tests/test_stream_sweep.py::_cfg()``, 16 mixes in chunks
  of 4 of 6 applications, ``baseline`` and ``CBP``, 20 ms, seed 7;
  healthy and under that file's kill-resume plan without its kill (a
  dispatch error at chunk 0, NaN poison at chunk 1);
- ``all_managers``: the 14 registered managers, 8 mixes in chunks of 4
  of 6 applications, 20 ms, seed 3, zipf popularity, a diurnal period of
  4 chunks and a phase-app fraction of 0.5 (every family stacked,
  auction and QoS included);
- ``bench_smoke``: ``benchmarks/stream_bench.py::_smoke_cfg``, 64 mixes
  in chunks of 16, ``baseline`` and ``CBP``, 20 ms, seed 11, zipf, a
  phase-app fraction of 0.25; healthy and under
  ``resume_parity_gate``'s plan without its kill;
- ``full_head``: the first 24 chunks (one diurnal period) of
  ``stream_bench.py::full``'s stream, 12,288 mixes in chunks of 512 of
  16 applications, ``baseline`` and ``CBP``, 50 ms, seed 11, zipf, a
  diurnal period of 24 chunks, a phase-app fraction of 0.25 (the card's
  case: ``chip_smoke.py`` phase 13).

    PYTHONPATH=src python tools/stream_golden.py

takes about 75 s on one core of an x86 server (``full_head`` about 45 s
of it).  It sets ``JAX_ENABLE_X64=1`` and ``JAX_PLATFORMS=cpu`` before it
imports JAX, and refuses to run if float64 is not on: without it the
reference's stream falls back to float32.  CBP's ``bench_smoke`` geomean
must round to the committed ``results/bench/stream_bench.json`` record's
``cbp_geomean_ws``, 1.401397; if it does not, the tool says so and exits
1 (it never edits ``results/bench/``).  ``tests/test_torch_stream_sweep.py``
regenerates the ``tests`` case in a float64 subprocess
(``tests/_torch_jax_ref.py``) and compares it with the committed file.
"""
from __future__ import annotations

import os

os.environ["JAX_ENABLE_X64"] = "1"
os.environ["JAX_PLATFORMS"] = "cpu"

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "tests" / "data" / "stream_golden.json"

#: ``results/bench/stream_bench.json``'s ``cbp_geomean_ws``.
RECORD_CBP_GEOMEAN = 1.401397

#: The kill-resume plan of ``tests/test_stream_sweep.py`` (l.390-392) and
#: of ``stream_bench.py::resume_parity_gate``, without its kill.
KILL_FREE_PLAN = [{"kind": "dispatch_error", "chunk": 0, "count": 1},
                  {"kind": "nan_poison", "chunk": 1}]

#: name -> (StreamConfig fields, with the scenario's as a dict; the fault
#: plans the case runs under, by name).
CASES = {
    "tests": ({"n_mixes": 16, "chunk_size": 4,
               "managers": ["baseline", "CBP"], "total_ms": 20.0, "seed": 7,
               "scenario": {"apps_per_mix": 6}},
              {"healthy": None, "faults": KILL_FREE_PLAN}),
    "all_managers": ({"n_mixes": 8, "chunk_size": 4, "managers": None,
                      "total_ms": 20.0, "seed": 3,
                      "scenario": {"apps_per_mix": 6, "popularity": "zipf",
                                   "diurnal_period_chunks": 4,
                                   "phase_app_fraction": 0.5}},
                     {"healthy": None}),
    "bench_smoke": ({"n_mixes": 64, "chunk_size": 16,
                     "managers": ["baseline", "CBP"], "total_ms": 20.0,
                     "seed": 11,
                     "scenario": {"popularity": "zipf",
                                  "phase_app_fraction": 0.25}},
                    {"healthy": None, "faults": KILL_FREE_PLAN}),
    "full_head": ({"n_mixes": 24 * 512, "chunk_size": 512,
                   "managers": ["baseline", "CBP"], "total_ms": 50.0,
                   "seed": 11,
                   "scenario": {"popularity": "zipf",
                                "diurnal_period_chunks": 24,
                                "phase_app_fraction": 0.25}},
                  {"healthy": None}),
}

#: Cases too long for the port's CPU tests (``chip_smoke.py`` holds them).
CARD_CASES = ("full_head",)

#: The report's rounded per-manager fields.
REPORT_FIELDS = ("geomean_ws", "p50_slowdown", "p90_slowdown",
                 "p99_slowdown", "max_slowdown", "min_fairness")


def stream_config(args: dict, stream_sweep, workloads, **kw):
    """A ``StreamConfig`` of one case from either package's modules (the
    reference's or the port's ``sim.stream_sweep`` and ``sim.workloads``)."""
    fields = {k: v for k, v in args.items() if k != "scenario"}
    if fields.get("managers") is not None:
        fields["managers"] = tuple(fields["managers"])
    return stream_sweep.StreamConfig(
        **fields, scenario=workloads.StreamScenario(**args["scenario"]),
        **kw)


def _require_x64() -> None:
    import jax

    if not jax.config.jax_enable_x64:
        raise SystemExit("tools/stream_golden.py: JAX runs without float64 "
                         "(set JAX_ENABLE_X64=1 before JAX is imported)")


def reference_run(args: dict, plan):
    """The reference's stream for one case and plan (``None``: healthy)."""
    _require_x64()
    from repro.runtime.faultinject import FaultPlan
    from repro.sim import stream_sweep, workloads

    return stream_sweep.run_stream(
        stream_config(args, stream_sweep, workloads),
        fault_plan=None if plan is None else FaultPlan.from_dicts(plan),
        sleep_fn=lambda s: None)


def encode(report) -> dict:
    """One run as JSON: the aggregate tree (floats as ``float.hex``), the
    report's rounded fields and the quarantined chunks."""
    tree = {}
    for key, a in report.aggregates.to_tree().items():
        tree[key] = (np.vectorize(float.hex, otypes=[object])(a).tolist()
                     if a.dtype == np.float64 else a.tolist())
    return {"aggregates": tree,
            "report": {**{f: getattr(report, f) for f in REPORT_FIELDS},
                       "coverage": report.coverage,
                       "mixes_covered": report.mixes_covered,
                       "retries": report.retries},
            "quarantined": [int(c) for c, _ in report.quarantined]}


def golden(names=tuple(CASES)) -> dict:
    from repro.sim import stream_sweep, workloads

    cases = {}
    for name in names:
        args, plans = CASES[name]
        cases[name] = {
            "config": args,
            "fingerprint": stream_config(
                args, stream_sweep, workloads).fingerprint(),
            "runs": {run: {"plan": plan,
                           **encode(reference_run(args, plan))}
                     for run, plan in plans.items()}}
    return {"source": "repro.sim.stream_sweep.run_stream in float64 on the "
                      "CPU (tools/stream_golden.py)",
            "cases": cases}


def dumps(data: dict) -> str:
    return json.dumps(data, separators=(",", ":")) + "\n"


def main() -> int:
    _require_x64()
    data = golden()
    text = dumps(data)
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(text)
    print(f"wrote {PATH} ({len(text)} bytes, {len(CASES)} cases)")
    geo = data["cases"]["bench_smoke"]["runs"]["healthy"]["report"][
        "geomean_ws"]["CBP"]
    if geo != RECORD_CBP_GEOMEAN:
        print(f"bench_smoke's CBP geomean {geo!r} is not the record's "
              f"{RECORD_CBP_GEOMEAN}", file=sys.stderr)
        return 1
    print(f"bench_smoke's CBP geomean {geo!r} equals the record's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
