"""Runtime bindings of CBP (counterpart of :mod:`repro.runtime`): the
kernel-level binding, the UCP block planner
(:mod:`repro_torch.runtime.cbp_runtime`), and the training-loop binding,
``TrainingPlant`` and the fused Fig. 8 knob schedule
(:mod:`repro_torch.runtime.plant`), and the streaming sweep's fault
tooling: the straggler watchdog and elastic mesh
(:mod:`repro_torch.runtime.fault`) and the seeded fault plans
(:mod:`repro_torch.runtime.faultinject`)."""
from repro_torch.runtime.cbp_runtime import (
    StreamKnobs,
    TrainingPlant,
    plan_kernel_blocks,
    plan_matmul_blocks,
    plan_matmul_blocks_batched,
)
from repro_torch.runtime.fault import (
    ElasticMesh,
    StragglerWatchdog,
    factorize_mesh,
)
from repro_torch.runtime.faultinject import (
    FAULT_KINDS,
    FaultPlan,
    FaultSpec,
    InjectedDispatchError,
    InjectedFault,
    InjectedProcessKill,
    poison_tree,
)
from repro_torch.runtime.plant import (
    FusedTrainingPlant,
    PlantScheduleResult,
    host_reference_run,
    run_fused_schedule,
)

__all__ = [
    "StreamKnobs", "TrainingPlant", "plan_kernel_blocks",
    "plan_matmul_blocks", "plan_matmul_blocks_batched",
    "FusedTrainingPlant", "PlantScheduleResult", "host_reference_run",
    "run_fused_schedule",
    "ElasticMesh", "StragglerWatchdog", "factorize_mesh",
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "InjectedDispatchError",
    "InjectedFault", "InjectedProcessKill", "poison_tree",
]
