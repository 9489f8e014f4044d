"""Mamba2 SSD chunk-scan kernel (port of the JAX package's
repro.kernels.ssd_scan)."""
from repro_torch.kernels.ssd_scan.ops import (
    LAUNCHES,
    smem_bytes,
    ssd_scan,
    ssd_scan_plain,
)

__all__ = ["LAUNCHES", "smem_bytes", "ssd_scan", "ssd_scan_plain"]
