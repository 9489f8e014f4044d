"""The 16-core CMP evaluation substrate on tensors (counterpart of
:mod:`repro.sim`): profiles, workloads, the interval model, the manager
registry, the scalar plant and its managers, the stacked Fig. 8
timelines, the Table-3 sweep, Fig. 5's static search
(:mod:`repro_torch.sim.static_search`), the fault-tolerant streaming sweep
(:mod:`repro_torch.sim.stream_sweep`) and the single-application
characterization (:mod:`repro_torch.sim.characterization`)."""
from repro_torch.sim.apps import AppArrays, from_numpy, stack_mixes
from repro_torch.sim.managers import (
    MANAGER_NAMES,
    TABLE3_MODES,
    ManagerResult,
    run_all_managers,
    run_manager,
)
from repro_torch.sim.runner import (
    CMPConfig,
    CMPPlant,
    antt,
    baseline_ipc,
    equal_share,
    weighted_speedup,
)
from repro_torch.sim.static_search import (
    FIG5_FAMILIES,
    FIG5_TWO_RESOURCE,
    FamilySpec,
    StaticGrid,
    StaticOptions,
    StaticSearchResult,
    enumerate_grid,
    family_grid,
    registry_families,
    search_static,
)
from repro_torch.sim.stream_sweep import (
    CheckpointMismatchError,
    NumericalDivergenceError,
    RetryPolicy,
    StreamAbortedError,
    StreamAggregates,
    StreamConfig,
    StreamReport,
    run_stream,
)
from repro_torch.sim.sweep import (
    BatchedCMPPlant,
    SweepResult,
    baseline_ipc_batched,
    run_sweep,
)
from repro_torch.sim.workloads import (
    WORKLOADS,
    random_mixes,
    random_workloads,
)

__all__ = [
    "AppArrays", "from_numpy", "stack_mixes",
    "MANAGER_NAMES", "TABLE3_MODES", "ManagerResult", "run_all_managers",
    "run_manager",
    "CMPConfig", "CMPPlant", "antt", "baseline_ipc", "equal_share",
    "weighted_speedup",
    "FIG5_FAMILIES", "FIG5_TWO_RESOURCE", "FamilySpec", "StaticGrid",
    "StaticOptions", "StaticSearchResult", "enumerate_grid", "family_grid",
    "registry_families", "search_static",
    "CheckpointMismatchError", "NumericalDivergenceError", "RetryPolicy",
    "StreamAbortedError", "StreamAggregates", "StreamConfig", "StreamReport",
    "run_stream",
    "BatchedCMPPlant", "SweepResult", "baseline_ipc_batched", "run_sweep",
    "WORKLOADS", "random_mixes", "random_workloads",
]
