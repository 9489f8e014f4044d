"""Flash-attention forward kernel (port of the JAX package's
repro.kernels.flash_attention)."""
from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    flash_attention,
    flash_attention_plain,
)

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_plain"]
