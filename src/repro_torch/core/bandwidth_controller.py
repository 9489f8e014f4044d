"""Bandwidth partitioning, paper §3.2.2 Algorithm 1 (counterpart of
:func:`repro.core.bandwidth_controller.allocate_bandwidth_jax` and of the
stateful :class:`~repro.core.bandwidth_controller.BandwidthController`).

Every client first receives ``min_allocation``; the remainder is split
pro-rata by accumulated queuing delay, evenly when no one queued.  The
``min_allocation * n > total`` feasibility check stays on the host
(:func:`check_bandwidth_floor`), validated once before a timeline runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.numpy_order import numpy_order_sum


def allocate_bandwidth(queuing_delay: torch.Tensor, total_bandwidth: float,
                       min_allocation, numpy_order: bool = False
                       ) -> torch.Tensor:
    """Algorithm 1 over ``(..., n)`` delays; ``min_allocation`` is a scalar
    or a ``(..., 1)`` tensor of per-row floors.  Same op order as the
    reference, so the result agrees with it to the last bits of a sum;
    ``numpy_order`` sums the delays in numpy's order
    (:func:`~repro_torch.numpy_order.numpy_order_sum`), the same on every
    device, so the result is the numpy golden's bit for bit.  Inside a
    CUDA graph capture pass ``min_allocation`` as a tensor on the delays'
    device (a Python scalar would be copied from the host)."""
    delay = queuing_delay
    n = delay.shape[-1]
    min_alloc = torch.as_tensor(min_allocation, dtype=delay.dtype,
                                device=delay.device)
    remaining = total_bandwidth - min_alloc * n
    total_delay = (numpy_order_sum(delay) if numpy_order
                   else delay.sum(dim=-1, keepdim=True))
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


class BandwidthController:
    """Stateful Algorithm 1 (counterpart of
    :class:`repro.core.bandwidth_controller.BandwidthController`): the
    per-client queuing delays accumulate across intervals (paper §3.3)
    with a decay so stale phases wash out.

    ``min_allocation`` and ``decay`` are scalars or per-row ``(..., 1)``
    arrays; the delays are ``(..., n)`` tensors.
    """

    def __init__(self, total_bandwidth: float, min_allocation,
                 decay=0.5):
        self.total_bandwidth = total_bandwidth
        self.min_allocation = min_allocation
        self.decay = decay
        self._acc: Optional[torch.Tensor] = None

    def observe(self, queuing_delay: torch.Tensor) -> None:
        delay = queuing_delay.to(torch.float64)
        if self._acc is None:
            self._acc = delay.clone()
        else:
            decay = torch.as_tensor(self.decay, dtype=delay.dtype,
                                    device=delay.device)
            self._acc = decay * self._acc + delay

    def allocate(self) -> torch.Tensor:
        if self._acc is None:
            raise RuntimeError("no delays observed yet")
        check_bandwidth_floor(self.min_allocation, self._acc.shape[-1],
                              self.total_bandwidth)
        return allocate_bandwidth(
            self._acc, self.total_bandwidth, self.min_allocation)
