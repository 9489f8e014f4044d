"""Single-application characterization, paper §2.1 and Figs. 2-4
(counterpart of :mod:`repro.sim.characterization`).

One application on one core at the baseline allocation (512 kB, 4 GB/s,
prefetch off); perturb one resource at a time and classify:

  C-L: cache ->128 kB     C-H: cache ->2 MB
  B-L: bandwidth ->1 GB/s B-H: bandwidth ->16 GB/s
  P-B: prefetch on at baseline allocation

An application is cache / bandwidth sensitive if a perturbation of that
resource moves IPC by >= 10 %, prefetch sensitive if prefetching speeds
it up by >= 10 %.

Every (application, allocation) point of a figure is one row of one
evaluation of the port's interval model (:func:`repro_torch.sim.memsys.
evaluate`) on ``device`` (``None``: the card).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import memsys
from repro_torch.sim.apps import APP_NAMES, app_fields, from_numpy, stack

SENSITIVITY_THRESHOLD = 0.10

# Single-app allocation points (units of 32 kB, GB/s).
BASE = (16, 4.0)     # 512 kB, 4 GB/s
C_L, C_H = 4, 64     # 128 kB, 2 MB
B_L, B_H = 1.0, 16.0

#: (app, cache units, GB/s, prefetch on) of one single-app evaluation.
Point = Tuple[str, float, float, bool]


def _ipcs(points: Sequence[Point], device: DeviceLike = None) -> np.ndarray:
    """IPC at each point, all points as rows of one ``(R, 1)`` evaluation
    (cache and bandwidth partitioned)."""
    dev = resolve_device(device)
    apps, units, bw, pf = zip(*points)
    params = from_numpy(app_fields(stack(list(apps))), dev)
    ss = memsys.evaluate(
        {k: v[:, None] for k, v in params.items()},
        np.array(units, dtype=np.float64)[:, None],
        np.array(bw, dtype=np.float64)[:, None],
        np.array(pf, dtype=np.float64)[:, None],
        cache_partitioned=True, bandwidth_partitioned=True)
    return ss.ipc[:, 0].cpu().numpy()


def _ipc(app: str, units: float, bw: float, pf: bool,
         device: DeviceLike = None) -> float:
    return float(_ipcs([(app, units, bw, pf)], device)[0])


def sensitivity_table(device: DeviceLike = None
                      ) -> Dict[str, Dict[str, float]]:
    """Relative IPC change for every perturbation, per app (Fig. 2 data)."""
    cases = (("base_ipc", BASE[0], BASE[1], False),
             ("C-L", C_L, BASE[1], False), ("C-H", C_H, BASE[1], False),
             ("B-L", BASE[0], B_L, False), ("B-H", BASE[0], B_H, False),
             ("P-B", BASE[0], BASE[1], True))
    ipc = _ipcs([(app, u, b, pf) for app in APP_NAMES
                 for _tag, u, b, pf in cases], device)
    ipc = ipc.reshape(len(APP_NAMES), len(cases))
    out: Dict[str, Dict[str, float]] = {}
    for app, row in zip(APP_NAMES, ipc):
        base = float(row[0])
        out[app] = {"base_ipc": base}
        for (tag, *_), v in zip(cases[1:], row[1:]):
            out[app][tag] = float(v) / base - 1.0
    return out


def classify(row: Dict[str, float]) -> str:
    cs = (abs(row["C-L"]) >= SENSITIVITY_THRESHOLD
          or abs(row["C-H"]) >= SENSITIVITY_THRESHOLD)
    bs = (abs(row["B-L"]) >= SENSITIVITY_THRESHOLD
          or abs(row["B-H"]) >= SENSITIVITY_THRESHOLD)
    # Paper §2.1: the PS class counts applications that are "sensitive to
    # prefetching and experience a speedup"; prefetch-averse applications
    # (e.g. xalancbmk) are handled by throttling but not labelled PS.
    ps = row["P-B"] >= SENSITIVITY_THRESHOLD
    tags = [t for t, on in (("CS", cs), ("BS", bs), ("PS", ps)) if on]
    return "-".join(tags) if tags else "I"


def classify_all(device: DeviceLike = None) -> Dict[str, str]:
    return {app: classify(row)
            for app, row in sensitivity_table(device).items()}


def prefetch_vs_allocation(app: str,
                           device: DeviceLike = None) -> Dict[str, float]:
    """Fig. 3: prefetch speedup at L/B/H allocation scenarios."""
    allocs = {"P-L": (C_L, B_L), "P-B": BASE, "P-H": (C_H, B_H)}
    ipc = _ipcs([(app, u, b, pf) for u, b in allocs.values()
                 for pf in (False, True)], device).reshape(-1, 2)
    return {tag: float(on) / float(off) - 1.0
            for tag, (off, on) in zip(allocs, ipc)}


def leslie3d_interactions(device: DeviceLike = None) -> Dict[str, object]:
    """Fig. 4: pairwise interaction curves for leslie3d."""
    app = "leslie3d"
    bw_points = [1.0, 2.0, 4.0, 8.0, 16.0]
    cache_points = [4, 8, 16, 32, 64]
    # IPC at (BASE cache, b) and (c, BASE bw), off and on, and at (C_H, b)
    # off: one evaluation.
    pts: List[Point] = (
        [(app, BASE[0], b, pf) for pf in (False, True) for b in bw_points]
        + [(app, c, BASE[1], pf) for pf in (False, True)
           for c in cache_points]
        + [(app, C_H, b, False) for b in bw_points])
    ipc = [float(x) for x in _ipcs(pts, device)]
    nb, nc = len(bw_points), len(cache_points)
    bw_off, bw_on = ipc[:nb], ipc[nb:2 * nb]
    c_off, c_on = ipc[2 * nb:2 * nb + nc], ipc[2 * nb + nc:2 * nb + 2 * nc]
    big = ipc[2 * nb + 2 * nc:]
    fig4a = {"bw": bw_points, "off": bw_off, "on": bw_on}
    fig4b = {"cache": cache_points,
             "speedup": [on / off for on, off in zip(c_on, c_off)]}
    fig4c = {"cache": cache_points, "off": c_off, "on": c_on}
    fig4d = {"bw": bw_points,
             "gain": [g / b - 1.0 for g, b in zip(big, bw_off)]}
    return {"fig4a": fig4a, "fig4b": fig4b, "fig4c": fig4c, "fig4d": fig4d}
