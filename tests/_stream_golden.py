"""The reference's streaming sweeps as data, for the port's tests:
``tests/data/stream_golden.json``, written by ``tools/stream_golden.py``
(floats as ``float.hex``).  Imports neither JAX nor the JAX package, so
the card tests use it too.

The port is held to it by the sweep's rule: the discrete results exactly
(``mix_count``, ``slowdown_hist``, the quarantined chunks, coverage,
retries), the float aggregates within :data:`RTOL`."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "stream_golden.json"

#: Cases too long for the CPU tests (``chip_smoke.py`` holds them).
CARD_CASES = ("full_head",)

#: Relative limit of the float aggregates: the port's sweep contract
#: (``tests/test_torch_sweep.py``).
RTOL = 1e-9

#: ``log_ws_sum`` of a manager whose weighted speedups are 1 up to
#: rounding (``baseline``: its timeline is the equal-share baseline
#: itself) is a sum of logs of one ulp or so, e.g. -0x1.2p-50 over the
#: 12,288 mixes of ``full_head``, where a relative limit means nothing.
#: Its floor is one ulp of 1.0 per mix: ``mix_count * EPS``.
EPS = float(np.finfo(np.float64).eps)

FLOAT_AGGREGATES = ("log_ws_sum", "max_slowdown", "min_fairness")
COUNT_AGGREGATES = ("mix_count", "slowdown_hist")

#: bench_smoke's CBP geomean in ``results/bench/stream_bench.json``.
RECORD_CBP_GEOMEAN = 1.401397


def _floats(v) -> np.ndarray:
    return np.vectorize(float.fromhex, otypes=[np.float64])(
        np.asarray(v, dtype=object))


def load() -> Dict[str, dict]:
    """{case: {"config", "fingerprint", "runs": {run: {"plan",
    "aggregates", "report", "quarantined"}}}}, the aggregates as numpy
    arrays."""
    data = json.loads(PATH.read_text())
    for case in data["cases"].values():
        for run in case["runs"].values():
            run["aggregates"] = {
                key: (_floats(v) if key in FLOAT_AGGREGATES
                      else np.asarray(v, dtype=np.int64))
                for key, v in run["aggregates"].items()}
    return data["cases"]


def port_config(args: dict, **kw):
    """The port's ``StreamConfig`` of one case (``kw`` adds fields)."""
    from repro_torch.sim.stream_sweep import StreamConfig
    from repro_torch.sim.workloads import StreamScenario

    fields = {k: v for k, v in args.items() if k != "scenario"}
    if fields.get("managers") is not None:
        fields["managers"] = tuple(fields["managers"])
    return StreamConfig(**fields, scenario=StreamScenario(**args["scenario"]),
                        **kw)


def port_plan(run: dict):
    """The port's ``FaultPlan`` of one golden run (``None``: healthy)."""
    from repro_torch.runtime.faultinject import FaultPlan

    return None if run["plan"] is None else FaultPlan.from_dicts(run["plan"])


def check_run(report, run: dict, what: str) -> float:
    """Hold a port report to one golden run; returns the largest relative
    distance of the float aggregates held by :data:`RTOL`."""
    tree = report.aggregates.to_tree()
    want = run["aggregates"]
    for key in COUNT_AGGREGATES:
        assert np.array_equal(tree[key], want[key]), (
            f"{what}: {key} differs from the golden")
    assert [c for c, _ in report.quarantined] == run["quarantined"], what
    for key in ("coverage", "mixes_covered", "retries"):
        assert getattr(report, key) == run["report"][key], (what, key)
    worst = 0.0
    for key in FLOAT_AGGREGATES:
        got, ref = tree[key], want[key]
        finite = np.isfinite(ref)
        assert np.array_equal(got[~finite], ref[~finite]), (what, key)
        diff = np.abs(got - ref)[finite]
        scale = np.abs(ref)[finite]
        floor = (want["mix_count"] * EPS)[finite] if key == "log_ws_sum" \
            else np.zeros_like(scale)
        assert (diff <= np.maximum(RTOL * scale, floor)).all(), (
            f"{what}: {key} {got.tolist()} off the golden {ref.tolist()}")
        held = (RTOL * scale >= floor) & (scale > 0)
        rel = diff[held] / scale[held]
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    return worst
