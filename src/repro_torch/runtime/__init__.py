"""Runtime bindings of CBP (counterpart of :mod:`repro.runtime`): so far
the kernel-level binding, the UCP block planner
(:mod:`repro_torch.runtime.cbp_runtime`)."""
