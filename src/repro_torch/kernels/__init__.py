"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see :mod:`repro_torch.kernels.build` for how they are built)."""
