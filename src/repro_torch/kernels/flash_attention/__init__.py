"""Flash-attention forward kernel (port of the JAX package's
repro.kernels.flash_attention)."""
from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    attention_smem_bytes,
    flash_attention,
    flash_attention_plain,
    tma_loads,
)

__all__ = ["LAUNCHES", "attention_smem_bytes", "flash_attention",
           "flash_attention_plain", "tma_loads"]
