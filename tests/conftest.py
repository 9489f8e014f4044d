def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels have no CPU "
        "interpret mode); skipped without one, run on the card with -m cuda")
