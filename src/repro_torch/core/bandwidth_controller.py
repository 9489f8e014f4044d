"""Bandwidth partitioning, paper §3.2.2 Algorithm 1 (counterpart of
:func:`repro.core.bandwidth_controller.allocate_bandwidth_jax`).

Every client first receives ``min_allocation``; the remainder is split
pro-rata by accumulated queuing delay, evenly when no one queued.  The
``min_allocation * n > total`` feasibility check stays on the host
(:func:`check_bandwidth_floor`), validated once before a timeline runs.
"""
from __future__ import annotations

import numpy as np
import torch


def allocate_bandwidth(queuing_delay: torch.Tensor, total_bandwidth: float,
                       min_allocation) -> torch.Tensor:
    """Algorithm 1 over ``(..., n)`` delays; ``min_allocation`` is a scalar
    or a ``(..., 1)`` tensor of per-row floors.  Same op order as the
    reference, so the result agrees with it to the last bits of a sum."""
    delay = queuing_delay
    n = delay.shape[-1]
    min_alloc = torch.as_tensor(min_allocation, dtype=delay.dtype,
                                device=delay.device)
    remaining = total_bandwidth - min_alloc * n
    total_delay = delay.sum(dim=-1, keepdim=True)
    share = torch.where(
        total_delay > 0,
        delay / torch.where(total_delay > 0, total_delay, 1.0),
        1.0 / n)
    return min_alloc + share * remaining


def check_bandwidth_floor(min_allocation, n_clients: int,
                          total_bandwidth: float) -> None:
    """Host-side feasibility check for Algorithm 1 (raises ``ValueError``)."""
    if np.any(np.asarray(min_allocation, dtype=np.float64) * n_clients
              > total_bandwidth):
        raise ValueError("min_allocation * n exceeds total bandwidth")
