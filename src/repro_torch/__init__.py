"""PyTorch and CUDA port of the CBP reproduction (:mod:`repro` is the JAX
reference it is held against).

The package mirrors :mod:`repro`'s layout: ``repro_torch.sim.memsys`` is
the counterpart of ``repro.sim.memsys_jax``, ``repro_torch.sim.timeline``
of ``repro.sim.timeline_jax``, and so on.  It imports ``torch`` and numpy
only — never ``jax`` and nothing of ``repro`` — and keeps its own copies
of the numpy host modules it needs (types, profiles, workloads, the
Fig. 8 schedule).

Entry points take ``device=None``, which means the CUDA card; without a
card they raise unless the caller asks for ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  The simulator and the
controllers compute in float64 throughout.
"""
