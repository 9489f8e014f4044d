"""Flash-decode kernel (port of the JAX package's
repro.kernels.flash_decode)."""
from repro_torch.kernels.flash_decode.ops import (
    LAUNCHES,
    flash_decode,
    flash_decode_plain,
)

__all__ = ["LAUNCHES", "flash_decode", "flash_decode_plain"]
