"""The reference's Fig. 5 static searches as data, for the port's tests:
``tests/data/static_search_golden.json``, written by
``tools/static_search_golden.py`` (floats as ``float.hex``).  Imports
neither JAX nor the JAX package, so the card tests use it too."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "static_search_golden.json"

#: Cases too long for the tier-1 run (``chip_smoke.py`` holds them).
LONG_CASES = ("study",)


def _floats(v) -> np.ndarray:
    return np.vectorize(float.fromhex, otypes=[np.float64])(
        np.asarray(v, dtype=object))


def load() -> Dict[str, Tuple[dict, dict]]:
    """{case: (arguments, golden)}; the golden's ``baseline_ipc`` and each
    family's ``topk_ws`` / ``topk_index`` / ``topk_fairness`` as numpy
    arrays (``int64`` indices)."""
    data = json.loads(PATH.read_text())
    out = {}
    for name, case in data["cases"].items():
        g = case["golden"]
        families = {}
        for fam, v in g["families"].items():
            families[fam] = {"topk_ws": _floats(v["topk_ws"]),
                             "topk_index": np.asarray(v["topk_index"],
                                                      dtype=np.int64)}
            if "topk_fairness" in v:
                families[fam]["topk_fairness"] = _floats(v["topk_fairness"])
        out[name] = (case["args"], {
            "workloads": g["workloads"],
            "baseline_ipc": _floats(g["baseline_ipc"]),
            "families": families, "geomeans": g["geomeans"]})
    return out


def port_run(args: dict, device: str, **kw):
    """The port's search for one case's arguments on ``device``."""
    from repro_torch.sim import static_search
    from repro_torch.sim.workloads import random_workloads

    fams = (static_search.FIG5_FAMILIES if args["families"] == "fig5"
            else static_search.registry_families())
    return static_search.search_static(
        random_workloads(args["n_workloads"], args["apps"], args["seed"]),
        {name: fams[name] for name in args.get("only", fams)},
        k=args["k"], device=device, multi_objective=args["multi_objective"],
        **kw)
