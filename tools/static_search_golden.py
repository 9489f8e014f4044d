#!/usr/bin/env python3
"""Write the reference's Fig. 5 static searches as data.

Runs the JAX package's golden for the static search,
``repro.sim.static_search.search_static(backend="numpy")`` (one numpy
solve of the interval model per workload), on the configurations the
port's search is held to, and writes
``tests/data/static_search_golden.json``: per case its arguments, the
workloads' names, the baseline IPC, per family the top-k weighted
speedups and config indices (with the min-fairness of a
``multi_objective`` case), floats as ``float.hex`` so that every bit
survives, and the geomean of each family's best weighted speedup.  The
cases:

- ``smoke``: ``benchmarks/fig5_smoke.py``'s configuration, 16 workloads
  of 4 applications from ``random_workloads(16, 4, seed=7)``, the six
  Fig. 5 families, k = 3;
- ``smoke_registry``: the same workloads over every family of the
  policy registry (``registry_families()``, the banked ``bank bw``
  among them), k = 3;
- ``study``: ``benchmarks/paper_figs.py::fig5_potential``'s, 640
  workloads of 4 from ``random_workloads(640, 4, seed=7)``, the six
  families, k = 1;
- ``pareto``: ``tests/test_static_search.py``'s Pareto case, 3 workloads
  of 2 from ``random_workloads(3, 2, seed=5)``, families ``cache+bw`` and
  ``cache+bw+pref``, k = 6, ``multi_objective=True``.

    PYTHONPATH=src python tools/static_search_golden.py

takes 4 min 25 s on one core of an x86 server (the study nearly all of
it, the other cases about 15 s).  The smoke configuration's all-three geomean
must round to the committed ``results/bench/fig5_smoke.json`` record's
``geo_all3``, 1.269; if it does not, the tool says so and exits 1 (it
writes the golden, and never edits ``results/bench/``).
``tests/test_torch_static_search.py`` regenerates every case but the
study in-process and compares it with the committed file.

The golden path is numpy only; it needs no float64 JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "tests" / "data" / "static_search_golden.json"

#: ``results/bench/fig5_smoke.json``'s ``geo_all3``.
RECORD_GEO_ALL3 = 1.269

#: name -> arguments: the workloads (``random_workloads(n_workloads,
#: apps, seed)``), the family set (``"fig5"``: ``FIG5_FAMILIES``,
#: ``"registry"``: ``registry_families()``; ``only``: a subset of it in
#: its order), ``k`` and ``multi_objective``.
CASES = {
    "smoke": {"n_workloads": 16, "apps": 4, "seed": 7, "families": "fig5",
              "k": 3, "multi_objective": False},
    "smoke_registry": {"n_workloads": 16, "apps": 4, "seed": 7,
                       "families": "registry", "k": 3,
                       "multi_objective": False},
    "study": {"n_workloads": 640, "apps": 4, "seed": 7, "families": "fig5",
              "k": 1, "multi_objective": False},
    "pareto": {"n_workloads": 3, "apps": 2, "seed": 5, "families": "fig5",
               "only": ["cache+bw", "cache+bw+pref"], "k": 6,
               "multi_objective": True},
}

#: Cases too long for the tier-1 run (``chip_smoke.py`` holds them).
LONG_CASES = ("study",)


def case_families(args: dict, static_search) -> dict:
    """The families of one case, from either package's ``static_search``
    module (the reference's or the port's)."""
    fams = (static_search.FIG5_FAMILIES if args["families"] == "fig5"
            else static_search.registry_families())
    return {name: fams[name] for name in args.get("only", fams)}


def reference_run(args: dict):
    """The reference's numpy search for one case's arguments."""
    from repro.sim import static_search
    from repro.sim.workloads import random_workloads

    return static_search.search_static(
        random_workloads(args["n_workloads"], args["apps"], args["seed"]),
        case_families(args, static_search), k=args["k"], backend="numpy",
        multi_objective=args["multi_objective"])


def _hex(a) -> list:
    return np.vectorize(float.hex, otypes=[object])(
        np.asarray(a, dtype=np.float64)).tolist()


def encode(res) -> dict:
    """One result as JSON: floats as ``float.hex``."""
    families = {}
    for name in res.family_names:
        fam = {"topk_ws": _hex(res.topk_ws[name]),
               "topk_index": res.topk_index[name].tolist()}
        if res.multi_objective:
            fam["topk_fairness"] = _hex(res.topk_fairness[name])
        families[name] = fam
    return {"workloads": res.workloads,
            "baseline_ipc": _hex(res.baseline_ipc),
            "families": families,
            "geomeans": {name: res.geomean(name)
                         for name in res.family_names}}


def golden(names=tuple(CASES)) -> dict:
    return {"source": "repro.sim.static_search.search_static("
                      "backend='numpy') (tools/static_search_golden.py)",
            "cases": {name: {"args": CASES[name],
                             "golden": encode(reference_run(CASES[name]))}
                      for name in names}}


def dumps(data: dict) -> str:
    return json.dumps(data, separators=(",", ":")) + "\n"


def main() -> int:
    data = golden()
    text = dumps(data)
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(text)
    print(f"wrote {PATH} ({len(text)} bytes, {len(CASES)} cases)")
    geo = data["cases"]["smoke"]["golden"]["geomeans"]["cache+bw+pref"]
    if round(geo, 3) != RECORD_GEO_ALL3:
        print(f"the smoke configuration's all-three geomean {geo!r} does "
              f"not round to the record's geo_all3 {RECORD_GEO_ALL3}",
              file=sys.stderr)
        return 1
    print(f"smoke geo_all3 {geo!r} rounds to the record's "
          f"{RECORD_GEO_ALL3}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
