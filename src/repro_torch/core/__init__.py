"""CBP's three controllers, the shared types and the kernel launch
counters on tensors (counterpart of :mod:`repro.core`).  Import the
submodules directly; this package re-exports nothing, so that the kernel
modules can use :mod:`repro_torch.core.dispatch` without importing the
controllers that call them."""
