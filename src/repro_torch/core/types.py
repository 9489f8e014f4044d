"""Shared types of the port (copy of :mod:`repro.core.types`), plus the
Fig. 8 schedule (:class:`ScheduleSegment`, :func:`fig8_schedule`, copied
from :mod:`repro.core.coordinator`).

The port keeps its own copy of these numpy-only definitions so that it
imports nothing of :mod:`repro`; ``tests/test_torch_sweep.py`` holds the
two in step.  :class:`Allocation` and :class:`IntervalStats` also hold
tensors (``Allocation.copy`` clones them).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class ScheduleConfigError(ValueError):
    """Raised when :class:`CBPParams` cannot form a Fig. 8 timeline.

    The Fig. 8 schedule spends ``2 * prefetch_sampling_period_ms`` of every
    reconfiguration interval on the A/B prefetch samples; if the interval is
    shorter than that, the "run" segment's duration goes negative, gets
    silently dropped, and the reconfigure boundaries drift off interval
    multiples — the host loop and the fused/stacked segment tables then
    disagree.  Rejecting the configuration up front keeps every backend on
    the same timeline.
    """


class Mode(enum.Enum):
    """How one of the three resources is managed (paper Table 3)."""

    UNPARTITIONED = "unpartitioned"  # free-for-all sharing (baseline)
    EQUAL = "equal"                  # static equal split ("equal off")
    DYNAMIC = "dynamic"              # managed by the local controller


class PrefetchMode(enum.Enum):
    OFF = "off"          # disabled for everyone (baseline / "* off" managers)
    ON = "on"            # enabled for everyone ("equal on")
    DYNAMIC = "dynamic"  # Algorithm 2 per-client throttling


def _copy(x):
    """A copy of a numpy array or a tensor (``clone``), same device."""
    return x.clone() if hasattr(x, "clone") else x.copy()


@dataclasses.dataclass
class Allocation:
    """A complete resource assignment for ``n`` clients.

    The fields are numpy arrays in results handed back to the caller, and
    tensors on the plant's device inside the host-coordinated loops
    (:mod:`repro_torch.core.coordinator`, :mod:`repro_torch.sim.managers`);
    a leading mix axis makes them ``(M, n)``.

    ``cache_units`` are allocation quanta (32 kB in the CMP model — one way of
    a 16-way 512 kB bank; KV pages or VMEM bytes in the TPU binding).
    ``bandwidth`` is in GB/s (CMP) or share-of-link (TPU).
    """

    cache_units: np.ndarray          # (n,) int
    bandwidth: np.ndarray            # (n,) float
    prefetch_on: np.ndarray          # (n,) bool
    cache_mode: Mode = Mode.DYNAMIC
    bandwidth_mode: Mode = Mode.DYNAMIC
    bandwidth_banks: int = 1         # >1: per-bank-token bandwidth regime

    @property
    def n(self) -> int:
        return len(self.cache_units)

    def copy(self) -> "Allocation":
        return Allocation(
            cache_units=_copy(self.cache_units),
            bandwidth=_copy(self.bandwidth),
            prefetch_on=_copy(self.prefetch_on),
            cache_mode=self.cache_mode,
            bandwidth_mode=self.bandwidth_mode,
            bandwidth_banks=self.bandwidth_banks,
        )


@dataclasses.dataclass
class IntervalStats:
    """Observations gathered while running one interval under an allocation.

    ``utility_curves[i, u]`` = hits client ``i`` would have seen with ``u``
    cache units during the interval (the ATD / stack-distance measurement,
    paper §3.2.1).  ``queuing_delay_ns`` is the mean per-request memory
    queuing delay (paper §3.2.2).  ``ipc`` is the performance signal sampled
    by the prefetch controller (paper §3.2.3); in the TPU binding it is
    tokens/sec or 1/step-time.
    """

    ipc: np.ndarray                   # (n,)
    queuing_delay_ns: np.ndarray      # (n,)
    utility_curves: np.ndarray        # (n, total_units + 1)
    instructions: Optional[np.ndarray] = None  # (n,) work completed

    @property
    def n(self) -> int:
        return len(self.ipc)


@dataclasses.dataclass
class CBPParams:
    """CBP tunables (paper Table 1, bottom block).

    The two decay constants govern how fast controller history washes out:
    ``atd_decay`` scales the ATD utility counters at every reconfiguration
    (paper §3.3, "the ATD values will be halved" — 0.5 is the paper's
    halving) and ``bandwidth_delay_decay`` is the
    Algorithm-1 queuing-delay accumulator decay applied per observed
    interval.  Both default to the paper's 0.5.
    """

    reconfiguration_interval_ms: float = 10.0
    prefetch_sampling_period_ms: float = 0.5
    speedup_threshold: float = 1.05
    prefetch_interval_ms: float = 10.0
    min_bandwidth_allocation: float = 1.0   # GB/s
    min_ways: int = 4                       # allocation quanta floor
    atd_decay: float = 0.5                  # ATD scale at reconfiguration
    bandwidth_delay_decay: float = 0.5      # queuing-delay accumulator decay

    def __post_init__(self):
        if self.reconfiguration_interval_ms <= 0:
            raise ScheduleConfigError(
                "reconfiguration_interval_ms must be positive, got "
                f"{self.reconfiguration_interval_ms!r}")
        if self.prefetch_sampling_period_ms <= 0:
            raise ScheduleConfigError(
                "prefetch_sampling_period_ms must be positive, got "
                f"{self.prefetch_sampling_period_ms!r}")
        if (self.reconfiguration_interval_ms
                < 2.0 * self.prefetch_sampling_period_ms):
            raise ScheduleConfigError(
                "reconfiguration_interval_ms "
                f"({self.reconfiguration_interval_ms!r}) must cover both "
                "prefetch samples: it has to be >= 2 * "
                "prefetch_sampling_period_ms "
                f"({self.prefetch_sampling_period_ms!r}); a shorter interval "
                "drops the 'run' segment and drifts the reconfigure "
                "boundaries off interval multiples")


@dataclasses.dataclass(frozen=True)
class ScheduleSegment:
    """One segment of the Fig. 8 timeline.

    ``kind`` is one of ``"reconfigure"`` (zero-duration boundary where the
    cache/bandwidth controllers fire), ``"sample_off"`` / ``"sample_on"``
    (the prefetch A/B sampling periods), and ``"run"`` (the remainder of the
    reconfiguration interval under the decided allocation).
    """

    kind: str
    duration_ms: float


def fig8_schedule(total_ms: float, params: CBPParams,
                  prefetch_dynamic: bool) -> List[ScheduleSegment]:
    """The Fig. 8 timeline as data, shared by every coordinator.

    The stacked sweep (:mod:`repro_torch.sim.sweep`) executes exactly this
    segment list, as the JAX package's coordinators do.  The
    non-boundary durations sum exactly to ``total_ms`` whenever each
    reconfiguration interval can contain its sampling overhead.

    :class:`CBPParams` rejects configurations whose
    sampling overhead exceeds the interval at construction; the check is
    repeated here because params are mutable dataclasses and a drifted
    schedule is silent otherwise.
    """
    if prefetch_dynamic and (params.reconfiguration_interval_ms
                             < 2.0 * params.prefetch_sampling_period_ms):
        raise ScheduleConfigError(
            "reconfiguration_interval_ms "
            f"({params.reconfiguration_interval_ms!r}) < 2 * "
            "prefetch_sampling_period_ms "
            f"({params.prefetch_sampling_period_ms!r}): the sampling "
            "overhead does not fit in the interval, so the 'run' segment "
            "would be dropped and reconfigure boundaries would drift")
    segments: List[ScheduleSegment] = []
    t = 0.0
    first = True
    while t < total_ms - 1e-9:
        if not first:
            segments.append(ScheduleSegment("reconfigure", 0.0))
        sampled = 0.0
        if prefetch_dynamic:
            p = params.prefetch_sampling_period_ms
            segments.append(ScheduleSegment("sample_off", p))
            segments.append(ScheduleSegment("sample_on", p))
            sampled = 2.0 * p
            t += sampled
        remain = min(params.reconfiguration_interval_ms - sampled,
                     total_ms - t)
        if remain > 0:
            segments.append(ScheduleSegment("run", remain))
            t += remain
        first = False
    return segments
