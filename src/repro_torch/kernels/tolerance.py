"""How closely each kernel of the kernel-level path must match its plain
PyTorch version on the same inputs (``chip_smoke.py`` and the card tests
hold the kernels to these limits).

Both sides compute in float32 (the matmul's plain version sums in
float64, the exact product), so they differ by the order and care of
their f32 sums.  In float32 the limit is ``atol = rtol`` = the JAX
package's own kernel tolerance (``F32_TOL``).  In bfloat16 both sides then round their
f32 result to 8 significant bits, which moves two nearly equal values at
most one bf16 ulp apart: the limit is ``rtol = 2^-7`` (one ulp relative
to the element, at the worst place in its binade) plus the f32 tolerance
scaled to the output, ``atol = F32_TOL * max|want|``.  The limit thus
follows the size of the output, whatever the inputs' scale.
"""
from __future__ import annotations

import torch

#: f32 atol = rtol per kernel: matmul 1e-4, attention and decode 2e-5,
#: SSD 2e-4 (its chunked sums against the sequential recurrence).
F32_TOL = {"cbp_matmul": 1e-4, "flash_attention": 2e-5,
           "flash_decode": 2e-5, "ssd_scan": 2e-4}
#: One bfloat16 ulp relative to the element it is the ulp of (at most).
BF16_RTOL = 2.0 ** -7


def limits(name: str, want: torch.Tensor) -> tuple[float, float]:
    """``(atol, rtol)`` for holding kernel ``name``'s output to ``want``,
    the plain version's output in the same dtype."""
    tol = F32_TOL[name]
    if want.dtype == torch.float32:
        return tol, tol
    if want.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {want.dtype}")
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    return tol * scale, BF16_RTOL
