"""Prefetch throttling, paper §3.2.3 Algorithm 2 (counterpart of
:func:`repro.core.prefetch_controller.throttle_decision_jax` and of the
stateful :class:`~repro.core.prefetch_controller.PrefetchController`)."""
from __future__ import annotations

import torch

from repro_torch.device import F64, DeviceLike, resolve_device


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


class PrefetchController:
    """Stateful wrapper tracking the current per-client setting."""

    def __init__(self, n_clients: int, speedup_threshold: float = 1.05,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.speedup_threshold = speedup_threshold
        self.enabled = torch.zeros(n_clients, dtype=torch.bool, device=dev)
        self.last_speedup = torch.ones(n_clients, dtype=F64, device=dev)

    def update(self, perf_with: torch.Tensor,
               perf_without: torch.Tensor) -> torch.Tensor:
        w = perf_with.to(F64)
        wo = perf_without.to(F64)
        self.last_speedup = torch.where(
            wo > 0, w / torch.clamp(wo, min=1e-12), 1.0)
        self.enabled = throttle_decision(w, wo, self.speedup_threshold)
        return self.enabled
