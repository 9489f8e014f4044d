"""Fault tolerance: straggler mitigation + elastic re-meshing (copy of
:mod:`repro.runtime.fault`, pure Python).

On real multi-pod deployments these hook the cluster control plane; the
logic itself is hardware-independent and fully tested on CPU:

* :class:`StragglerWatchdog` — EWMA step-time monitor; steps slower than
  ``threshold x`` the moving average are flagged; after ``quarantine_after``
  consecutive flags the policy asks for mitigation (re-mesh without the
  slow pod / reroute).  This is CBP thinking applied to time: the watchdog
  is a queuing-delay monitor over steps.
* :class:`ElasticMesh` — given a (changed) healthy-device count, recompute
  the best (dp, model) mesh factorization subject to the model's
  divisibility constraints, preferring to keep the model axis, so training
  resumes from the latest checkpoint after losing nodes.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Tuple


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float


class StragglerWatchdog:
    """EWMA step-time monitor with a median-seeded warm-up window.

    The baseline is seeded from the *median* of the first ``warmup``
    observations, never from the first observation alone: step 0 is
    routinely 10-100x slower than steady state (jit compilation, cold
    caches), and seeding the EWMA with it would inflate the baseline so
    far that genuine stragglers later never cross ``threshold x ewma``.
    ``warmup=1`` reproduces the old seed-from-first-step behaviour.
    """

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 quarantine_after: int = 3, warmup: int = 3):
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        self.threshold = threshold
        self.alpha = alpha
        self.quarantine_after = quarantine_after
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._consecutive = 0
        self._warmup_times: List[float] = []
        self.mitigations = 0

    def observe(self, step: int, step_time: float) -> bool:
        """Returns True when mitigation should trigger."""
        if self.ewma is None:
            # Warm-up window: no baseline yet, nothing can be flagged.
            self._warmup_times.append(step_time)
            if len(self._warmup_times) >= self.warmup:
                self.ewma = statistics.median(self._warmup_times)
                self._warmup_times.clear()
            return False
        flagged = step_time > self.threshold * self.ewma
        if flagged:
            self.events.append(StragglerEvent(step, step_time, self.ewma))
            self._consecutive += 1
        else:
            self._consecutive = 0
            # only healthy steps update the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        if self._consecutive >= self.quarantine_after:
            self._consecutive = 0
            self.mitigations += 1
            return True
        return False


def factorize_mesh(n_devices: int, *, model_divisors: Tuple[int, ...],
                   prefer_model: int) -> Optional[Tuple[int, int]]:
    """Best (dp, model) for ``n_devices``: the largest feasible model-axis
    size <= prefer_model that divides n_devices and satisfies the model's
    divisibility constraints (d_ff, heads, experts)."""
    for m in sorted({d for d in model_divisors if d <= prefer_model},
                    reverse=True):
        if m > 0 and n_devices % m == 0:
            return n_devices // m, m
    return None


class ElasticMesh:
    """Recompute the mesh when the healthy-device count changes."""

    def __init__(self, model_divisors: Tuple[int, ...] = (1, 2, 4, 8, 16),
                 prefer_model: int = 16):
        self.model_divisors = model_divisors
        self.prefer_model = prefer_model
        self.history: List[Tuple[int, Tuple[int, int]]] = []

    def remesh(self, n_devices: int) -> Tuple[int, int]:
        shape = factorize_mesh(
            n_devices, model_divisors=self.model_divisors,
            prefer_model=self.prefer_model)
        if shape is None:
            raise ValueError(
                f"no feasible mesh for {n_devices} devices "
                f"(model divisors {self.model_divisors})")
        self.history.append((n_devices, shape))
        return shape
