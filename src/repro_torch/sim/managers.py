"""Manager-name lists of the sweep (counterpart of the registry-derived
names of :mod:`repro.sim.managers`)."""
from __future__ import annotations

from repro_torch.sim import policies

#: Every registered family, in registry order.
MANAGER_NAMES = policies.manager_names()

#: (cache_mode, bandwidth_mode, prefetch_mode) of the classic Table-3
#: mode-combination families.
TABLE3_MODES = policies.table3_modes()
