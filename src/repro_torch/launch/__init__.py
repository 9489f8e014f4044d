"""Entry points of the port (counterpart of :mod:`repro.launch`):
``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.launch.train``."""
