"""CBP blocked matmul kernel (port of the JAX package's
repro.kernels.cbp_matmul)."""
from repro_torch.kernels.cbp_matmul.ops import (
    LAUNCHES,
    cbp_matmul,
    cbp_matmul_plain,
    ring_stages,
    smem_footprint_bytes,
    tma_loads,
)

__all__ = ["LAUNCHES", "cbp_matmul", "cbp_matmul_plain", "ring_stages",
           "smem_footprint_bytes", "tma_loads"]
