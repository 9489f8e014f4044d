"""The 16-core CMP evaluation substrate on tensors (counterpart of
:mod:`repro.sim`): profiles, workloads, the interval model, the manager
registry, the stacked Fig. 8 timelines and the Table-3 sweep."""
from repro_torch.sim.apps import AppArrays, from_numpy, stack_mixes
from repro_torch.sim.managers import MANAGER_NAMES, TABLE3_MODES
from repro_torch.sim.runner import CMPConfig, equal_share
from repro_torch.sim.sweep import (
    BatchedCMPPlant,
    SweepResult,
    baseline_ipc_batched,
    run_sweep,
)
from repro_torch.sim.workloads import WORKLOADS, random_mixes

__all__ = [
    "AppArrays", "from_numpy", "stack_mixes",
    "MANAGER_NAMES", "TABLE3_MODES",
    "CMPConfig", "equal_share",
    "BatchedCMPPlant", "SweepResult", "baseline_ipc_batched", "run_sweep",
    "WORKLOADS", "random_mixes",
]
