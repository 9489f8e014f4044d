"""The CMP plant: the interval model bound to the CBP coordinator
(counterpart of :mod:`repro.sim.runner`).

:class:`CMPPlant` implements :class:`repro_torch.core.coordinator.Plant`
for one workload mix: ``run_interval`` evaluates the port's interval
model (:func:`repro_torch.sim.memsys.evaluate`) under an allocation of
tensors on the plant's device and reports IPC, queuing delays and the
ATD utility curves.  Every Table-3 manager runs on it
(:mod:`repro_torch.sim.managers`).

The reference's ``CMPConfig.backend`` (its numpy golden model or the JAX
model) has no counterpart: the port has one model, on tensors, and runs
it on the device the caller names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.types import Allocation, IntervalStats, Mode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import apps as apps_mod
from repro_torch.sim import memsys
from repro_torch.sim.apps import AppArrays, app_fields, from_numpy, stack


@dataclasses.dataclass
class CMPConfig:
    total_cache_units: int = apps_mod.TOTAL_UNITS_8MB
    total_bandwidth: float = apps_mod.TOTAL_BW_GBPS
    llc_extra_cycles: float = 0.0   # added LLC hit latency (bigger tiles)
    #: Where the Lookahead allocator runs: "device" (the batched greedy on
    #: the plant's device: the CUDA kernel on the card, its plain version
    #: on the CPU) or "numpy" (the host golden, row by row).  "auto" is
    #: "device".
    allocator_backend: str = "auto"
    #: How :func:`repro_torch.sim.sweep.run_sweep` runs the managers'
    #: timelines: "stacked" runs the whole manager set as one stacked
    #: timeline; "fused" runs one timeline per manager, the reference the
    #: stacked run is held to bit for bit; "segment" is the per-segment
    #: host loop (one model evaluation per Fig. 8 segment, the controllers
    #: between them).  "auto" stacks unless the allocator is "numpy",
    #: which only the segment loop can honour.
    timeline_backend: str = "auto"


def _resolve_allocator_backend(config: CMPConfig,
                               default: str = "device") -> str:
    backend = config.allocator_backend
    if backend == "auto":
        backend = default
    if backend not in ("numpy", "device"):
        raise ValueError(f"unknown allocator backend {backend!r}")
    return backend


def _resolve_timeline_backend(config: CMPConfig,
                              default: str = "stacked") -> str:
    backend = config.timeline_backend
    if backend == "auto":
        backend = default
    if backend not in ("stacked", "fused", "segment"):
        raise ValueError(f"unknown timeline backend {backend!r}")
    return backend


class CMPPlant:
    """16-core tiled CMP interval model (paper Table 1) as a CBP plant,
    for one mix: its profiles are ``(n,)`` float64 tensors on ``device``
    (``None``: the card)."""

    def __init__(self, workload: Sequence[str],
                 config: Optional[CMPConfig] = None,
                 device: DeviceLike = None):
        self.apps: AppArrays = stack(list(workload))
        self.config = config or CMPConfig()
        self.device = resolve_device(device)
        self.params = from_numpy(app_fields(self.apps), self.device)
        self.allocator_backend = _resolve_allocator_backend(self.config)
        self.n_clients = len(workload)
        self.total_cache_units = self.config.total_cache_units
        self.total_bandwidth = self.config.total_bandwidth

    def evaluate(self, alloc: Allocation) -> memsys.SteadyState:
        return memsys.evaluate(
            self.params,
            alloc.cache_units,
            alloc.bandwidth,
            alloc.prefetch_on,
            cache_partitioned=alloc.cache_mode != Mode.UNPARTITIONED,
            bandwidth_partitioned=alloc.bandwidth_mode != Mode.UNPARTITIONED,
            total_cache_units=float(self.total_cache_units),
            total_bandwidth_gbps=self.total_bandwidth,
            llc_extra_cycles=self.config.llc_extra_cycles,
            bandwidth_banks=alloc.bandwidth_banks,
        )

    def run_interval(self, alloc: Allocation,
                     duration_ms: float) -> IntervalStats:
        ss = self.evaluate(alloc)
        curves = memsys.utility_curves(
            self.params, alloc.prefetch_on, ss.ipc,
            self.total_cache_units, duration_ms=1.0)
        return IntervalStats(
            ipc=ss.ipc,
            queuing_delay_ns=ss.queuing_delay_ns,
            utility_curves=curves,
            instructions=ss.ipc * memsys.FREQ_GHZ * 1e6 * duration_ms,
        )


def equal_share(n: int, total_units, total_bandwidth):
    """Equal-share per-app allocation: ``total_units // n`` cache units
    and ``total_bandwidth / n`` GB/s each — the one baseline construction."""
    units = np.full(n, int(total_units) // n, dtype=np.int64)
    bw = np.full(n, float(total_bandwidth) / n, dtype=np.float64)
    return units, bw


def baseline_ipc(workload: Sequence[str],
                 config: Optional[CMPConfig] = None,
                 device: DeviceLike = None) -> np.ndarray:
    """Paper baseline: unpartitioned cache + bandwidth, prefetch disabled;
    per-app IPC on the host."""
    plant = CMPPlant(workload, config, device=device)
    n = plant.n_clients
    units, bw = equal_share(n, plant.total_cache_units, plant.total_bandwidth)
    alloc = Allocation(
        cache_units=units,
        bandwidth=bw,
        prefetch_on=np.zeros(n, dtype=bool),
        cache_mode=Mode.UNPARTITIONED,
        bandwidth_mode=Mode.UNPARTITIONED,
    )
    return plant.evaluate(alloc).ipc.cpu().numpy()


def weighted_speedup(ipc_rm: np.ndarray, ipc_base: np.ndarray) -> float:
    """Paper §4.3: (1/N) * sum(IPC_RM / IPC_baseline)."""
    return float(np.mean(ipc_rm / ipc_base))


def antt(ipc_rm: np.ndarray, ipc_base: np.ndarray) -> float:
    """Paper §4.3: average normalized turnaround time (lower is better)."""
    return float(np.mean(ipc_base / ipc_rm))
