"""Entry points of the port (counterpart of :mod:`repro.launch`):
``python -m repro_torch.launch.serve``."""
