"""CMP configuration and the equal-share baseline allocation
(counterpart of the parts of :mod:`repro.sim.runner` the sweep uses)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim import apps as apps_mod


@dataclasses.dataclass
class CMPConfig:
    total_cache_units: int = apps_mod.TOTAL_UNITS_8MB
    total_bandwidth: float = apps_mod.TOTAL_BW_GBPS
    llc_extra_cycles: float = 0.0   # added LLC hit latency (bigger tiles)
    #: How :func:`repro_torch.sim.sweep.run_sweep` runs the managers'
    #: timelines: "stacked" (the default for "auto") runs the whole manager
    #: set as one stacked timeline; "fused" runs one timeline per manager,
    #: the reference the stacked run is held to bit for bit; "segment"
    #: (the reference's per-segment host loop) is not ported yet.
    timeline_backend: str = "auto"


def equal_share(n: int, total_units, total_bandwidth):
    """Equal-share per-app allocation: ``total_units // n`` cache units
    and ``total_bandwidth / n`` GB/s each — the one baseline construction."""
    units = np.full(n, int(total_units) // n, dtype=np.int64)
    bw = np.full(n, float(total_bandwidth) / n, dtype=np.float64)
    return units, bw
