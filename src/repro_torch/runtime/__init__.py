"""Runtime bindings of CBP (counterpart of :mod:`repro.runtime`): the
kernel-level binding, the UCP block planner
(:mod:`repro_torch.runtime.cbp_runtime`), and the training-loop binding,
``TrainingPlant`` and the fused Fig. 8 knob schedule
(:mod:`repro_torch.runtime.plant`).  The streaming sweep's fault tooling
(``repro.runtime.fault``, ``repro.runtime.faultinject``) is not ported
yet."""
from repro_torch.runtime.cbp_runtime import (
    StreamKnobs,
    TrainingPlant,
    plan_kernel_blocks,
    plan_matmul_blocks,
    plan_matmul_blocks_batched,
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
]
