"""CBP coordination mechanism, paper §3.3 and Figs. 6-8 (counterpart of
:mod:`repro.core.coordinator`).

The coordinator owns the three local controllers and runs the Fig. 8
timeline (:func:`repro_torch.core.types.fig8_schedule`, shared with the
stacked sweep) against a *plant*: anything that runs an interval under an
allocation and reports :class:`~repro_torch.core.types.IntervalStats`.
The state — ATD counters, delay accumulator, allocation — is tensors on
the plant's device; on the card each reconfiguration's cache allocation
is one launch of the Lookahead greedy kernel.

Controller priority (paper §3.3): cache first, then bandwidth, then
prefetch.  The feedback between them is implicit in the measurement loop:
the bandwidth controller sees delays that reflect the cache allocation
and prefetch misses, the prefetch A/B samples run under the current
cache and bandwidth allocation, and the ATD counters see prefetch hits,
which shrinks the next cache allocation of prefetch-friendly clients.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch.core.atd import SampledATD
from repro_torch.core.bandwidth_controller import BandwidthController
from repro_torch.core.cache_controller import CacheController
from repro_torch.core.prefetch_controller import PrefetchController
from repro_torch.core.types import (
    Allocation,
    CBPParams,
    IntervalStats,
    Mode,
    PrefetchMode,
    fig8_schedule,
)
from repro_torch.device import F64, lead_tensor


class Plant(Protocol):
    """What the coordinator manages.

    ``allocator_backend`` selects where the Lookahead allocator runs
    (``"device"``: the batched greedy on ``device``; ``"numpy"``: the host
    golden).  ``run_interval`` takes an allocation of tensors on
    ``device`` and returns stats of tensors there.
    """

    n_clients: int
    total_cache_units: int
    total_bandwidth: float
    allocator_backend: str
    device: torch.device

    def run_interval(self, alloc: Allocation,
                     duration_ms: float) -> IntervalStats:
        """Execute ``duration_ms`` under ``alloc`` and report observations."""
        ...


@dataclasses.dataclass
class IntervalRecord:
    t_ms: float
    duration_ms: float
    alloc: Allocation
    stats: IntervalStats


#: The CBPParams fields a caller may give one value per leading row.
TUNABLES = ("min_ways", "speedup_threshold", "min_bandwidth_allocation",
            "atd_decay", "bandwidth_delay_decay")


class CBPCoordinator:
    """Dynamically manage cache, bandwidth and prefetch (paper Fig. 8).

    ``cache_mode`` / ``bandwidth_mode`` / ``prefetch_mode`` select the
    Table-3 manager family; CBP proper is (DYNAMIC, DYNAMIC, DYNAMIC).
    Subset managers reuse the same loop with the unmanaged resource
    pinned.

    Shape-agnostic over a leading mix axis: the plant is the scalar
    :class:`~repro_torch.sim.runner.CMPPlant` (state ``(n,)``, one
    :class:`IntervalRecord` per executed interval in ``history``) or the
    sweep's ``BatchedCMPPlant`` (``n_mixes`` set, state ``(M, n)``, no
    history).  ``tunables`` overrides any of :data:`TUNABLES` with one
    value per mix (min_ways ``(M,)``, the others ``(M, 1)`` or ``(M, 1,
    1)``); the schedule comes from ``params``.
    """

    def __init__(
        self,
        plant: Plant,
        params: Optional[CBPParams] = None,
        cache_mode: Mode = Mode.DYNAMIC,
        bandwidth_mode: Mode = Mode.DYNAMIC,
        prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
        tunables: Optional[Dict[str, object]] = None,
    ):
        self.plant = plant
        self.params = params or CBPParams()
        self.cache_mode = cache_mode
        self.bandwidth_mode = bandwidth_mode
        self.prefetch_mode = prefetch_mode

        n = plant.n_clients
        self.device = dev = plant.device
        m = getattr(plant, "n_mixes", None)
        self._lead = () if m is None else (m,)
        t = {f: getattr(self.params, f) for f in TUNABLES}
        t.update(tunables or {})
        self._min_ways = t["min_ways"]
        self._atd_decay = lead_tensor(t["atd_decay"], self._lead, 2, F64, dev)
        self.atd = SampledATD(n, plant.total_cache_units, device=dev,
                              batch_shape=self._lead)
        self.cache_ctl = CacheController(
            plant.total_cache_units, self.params.min_ways,
            backend=plant.allocator_backend)
        self.bw_ctl = BandwidthController(
            plant.total_bandwidth, t["min_bandwidth_allocation"],
            decay=t["bandwidth_delay_decay"])
        self.pf_ctl = PrefetchController(n, t["speedup_threshold"],
                                         device=dev)
        self.history: List[IntervalRecord] = []
        self._t_ms = 0.0
        self._ipc_acc = torch.zeros(self._lead + (n,), dtype=F64, device=dev)
        self._w_acc = 0.0

        # Step 0 (Fig. 8): equal partitions, no miss/delay info yet.
        self.alloc = self._initial_allocation()

    # ------------------------------------------------------------------ #

    def _initial_allocation(self) -> Allocation:
        n, lead, dev = self.plant.n_clients, self._lead, self.device
        units = np.full(n, self.plant.total_cache_units // n, dtype=np.int64)
        units[: self.plant.total_cache_units - int(units.sum())] += 1
        return Allocation(
            cache_units=torch.as_tensor(
                np.broadcast_to(units, lead + (n,)).copy(), device=dev),
            bandwidth=torch.full(lead + (n,), self.plant.total_bandwidth / n,
                                 dtype=F64, device=dev),
            prefetch_on=torch.full(lead + (n,),
                                   self.prefetch_mode == PrefetchMode.ON,
                                   dtype=torch.bool, device=dev),
            cache_mode=self.cache_mode,
            bandwidth_mode=self.bandwidth_mode,
        )

    def _run(self, alloc: Allocation, duration_ms: float) -> IntervalStats:
        stats = self.plant.run_interval(alloc, duration_ms)
        self.atd.record(stats.utility_curves * (duration_ms / 1.0))
        self.bw_ctl.observe(stats.queuing_delay_ns * duration_ms)
        self._ipc_acc = self._ipc_acc + stats.ipc * duration_ms
        self._w_acc += duration_ms
        if not self._lead:
            self.history.append(
                IntervalRecord(self._t_ms, duration_ms, alloc.copy(), stats))
        self._t_ms += duration_ms
        return stats

    def _reconfigure(self) -> None:
        """Reconfiguration boundary: cache -> bandwidth (priority order)."""
        if self.cache_mode == Mode.DYNAMIC:
            # Interaction #5: the curves include prefetch hits, so
            # prefetch-friendly clients present flatter curves.
            self.alloc.cache_units = self.cache_ctl.allocate(
                self.atd.utility_curves(), min_units=self._min_ways)
        self.atd.halve(self._atd_decay)
        if self.bandwidth_mode == Mode.DYNAMIC:
            # Interactions #1/#2: delays reflect the cache allocation and
            # prefetch misses of the prior interval.
            self.alloc.bandwidth = self.bw_ctl.allocate()

    def _with_prefetch(self, value: bool) -> Allocation:
        alloc = self.alloc.copy()
        alloc.prefetch_on = torch.full_like(self.alloc.prefetch_on, value)
        return alloc

    # ------------------------------------------------------------------ #

    def run(self, total_ms: float) -> List[IntervalRecord]:
        """Run the Fig. 8 timeline for ``total_ms``; the A/B samples run
        under the *current* cache and bandwidth allocation (interactions
        #3/#4)."""
        stats_off: Optional[IntervalStats] = None
        schedule = fig8_schedule(
            total_ms, self.params,
            self.prefetch_mode == PrefetchMode.DYNAMIC)
        for seg in schedule:
            if seg.kind == "reconfigure":     # Steps 2-3
                self._reconfigure()
            elif seg.kind == "sample_off":    # Step 1/4
                stats_off = self._run(self._with_prefetch(False),
                                      seg.duration_ms)
            elif seg.kind == "sample_on":
                stats_on = self._run(self._with_prefetch(True),
                                     seg.duration_ms)
                self.alloc.prefetch_on = self.pf_ctl.update(
                    stats_on.ipc, stats_off.ipc)
            else:
                self._run(self.alloc, seg.duration_ms)
        return self.history

    # Aggregation helpers ------------------------------------------------ #

    def mean_ipc(self) -> np.ndarray:
        """Time-weighted mean performance per client over the run, on the
        host."""
        return (self._ipc_acc / max(self._w_acc, 1e-12)).cpu().numpy()
