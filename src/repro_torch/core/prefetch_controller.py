"""Prefetch throttling, paper §3.2.3 Algorithm 2 (counterpart of
:func:`repro.core.prefetch_controller.throttle_decision_jax`)."""
from __future__ import annotations

import torch


def throttle_decision(perf_with: torch.Tensor, perf_without: torch.Tensor,
                      speedup_threshold=1.05) -> torch.Tensor:
    """Enable the prefetcher iff the A/B speedup exceeds the threshold.

    ``speedup_threshold`` is a scalar or a ``(..., 1)`` tensor of per-row
    thresholds.  Returns a ``(..., n)`` bool tensor.
    """
    w = perf_with
    wo = perf_without.to(w.dtype)
    speedup = torch.where(wo > 0, w / torch.clamp(wo, min=1e-12), 1.0)
    return speedup > torch.as_tensor(speedup_threshold, dtype=w.dtype,
                                     device=w.device)
