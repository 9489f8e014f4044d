"""Auxiliary Tag Directory (ATD) machinery, paper §3.2.1 / §3.4 (copy of
:mod:`repro.core.atd`).

* :class:`SampledATD` — the per-client utility counters the cache
  controller reads, here a float64 tensor on the plant's device.  The
  plant feeds it per-interval hits-vs-units curves; the counters are
  scaled by the ATD decay after every reconfiguration (paper §3.3, "The
  ATD values will be halved after each reconfiguration").
* :class:`StackDistanceMonitor` — an online LRU stack-distance histogram
  on the host, copied as it is, for the serving binding's KV-pool
  clients.
"""
from __future__ import annotations

from typing import Dict, Hashable, List

import numpy as np
import torch

from repro_torch.device import F64, DeviceLike, resolve_device


class SampledATD:
    """Per-client utility counters with reconfiguration-time decay, as a
    ``batch_shape + (n_clients, total_units + 1)`` float64 tensor on
    ``device`` (the sweep's segment loop keeps one row per mix)."""

    def __init__(self, n_clients: int, total_units: int,
                 device: DeviceLike = None, batch_shape: tuple = ()):
        self.n_clients = n_clients
        self.total_units = total_units
        self._counters = torch.zeros(
            tuple(batch_shape) + (n_clients, total_units + 1),
            dtype=F64, device=resolve_device(device))

    def record(self, utility_curves) -> None:
        """Accumulate an interval's hits-vs-units measurement.

        ``utility_curves[i, u]`` = hits client ``i`` would have observed
        with ``u`` units during the interval (non-decreasing in ``u``).
        """
        curves = torch.as_tensor(utility_curves, dtype=F64,
                                 device=self._counters.device)
        if curves.shape != self._counters.shape:
            raise ValueError(
                f"expected {tuple(self._counters.shape)}, got "
                f"{tuple(curves.shape)}")
        self._counters += curves

    def halve(self, decay=0.5) -> None:
        """Decay history so recent behaviour dominates (paper §3.3);
        ``decay`` is wired from ``CBPParams.atd_decay``: a scalar, or a
        tensor of one value per leading row."""
        self._counters *= decay

    def utility_curves(self) -> torch.Tensor:
        """Current hits-vs-units estimate, shape ``batch_shape +
        (n_clients, units + 1)``."""
        return self._counters.clone()

    def reset(self) -> None:
        self._counters.zero_()


class StackDistanceMonitor:
    """Online LRU stack-distance histogram over an access stream.

    ``access(key)`` returns the LRU stack distance of ``key`` (0 == MRU
    hit, ``max_units`` == cold miss) and updates the recency stack.  The
    histogram answers: *with c units of cache, how many of the observed
    accesses would have hit?* — the utility curve the Lookahead allocator
    consumes.
    """

    def __init__(self, max_units: int):
        self.max_units = max_units
        self._stack: List[Hashable] = []      # index 0 == MRU
        self._pos: Dict[Hashable, int] = {}   # key -> stack index (lazy)
        self._hist = np.zeros(max_units + 1, dtype=np.float64)  # [d] counts
        self._cold = 0.0
        self._accesses = 0.0

    def access(self, key: Hashable) -> int:
        self._accesses += 1
        try:
            depth = self._stack.index(key)
        except ValueError:
            depth = -1
        if depth < 0:
            self._cold += 1
            self._stack.insert(0, key)
            if len(self._stack) > self.max_units:
                self._stack.pop()
            return self.max_units
        # Hit at stack distance `depth`: with > depth units it would hit.
        if depth < len(self._hist):
            self._hist[depth] += 1
        else:
            self._cold += 1
        self._stack.pop(depth)
        self._stack.insert(0, key)
        return depth

    def utility_curve(self) -> np.ndarray:
        """hits(u) for u in 0..max_units (non-decreasing)."""
        hits = np.zeros(self.max_units + 1, dtype=np.float64)
        np.cumsum(self._hist[:-1], out=hits[1:])
        return hits

    def halve(self) -> None:
        self._hist *= 0.5
        self._cold *= 0.5
        self._accesses *= 0.5

    @property
    def accesses(self) -> float:
        return self._accesses
