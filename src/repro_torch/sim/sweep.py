"""The Table-3 sweep: every manager family over many mixes (counterpart of
:mod:`repro.sim.sweep`, the paper's Figs. 9-12 evaluation substrate).

:func:`run_sweep` builds one :class:`~repro_torch.sim.timeline.
TimelineSpec` per manager (:func:`_manager_spec`, the same wiring as the
reference), runs the whole set as one stacked timeline on the device
(:func:`repro_torch.sim.timeline.run_timelines`) and turns the mean IPC
into weighted speedup against the shared equal-share baseline
(:func:`baseline_ipc_batched`).

Backends (``CMPConfig.timeline_backend``): ``"stacked"`` (the default)
runs all managers in one stacked timeline; ``"fused"`` runs the same
specs one manager at a time, the reference the stacked run equals bit for
bit.  The reference's ``"segment"`` host loop and ``param_grid`` are not
ported yet (ROADMAP Queue A, item 12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import (
    Allocation,
    CBPParams,
    Mode,
    PrefetchMode,
    ScheduleSegment,
    fig8_schedule,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import memsys, policies, timeline
from repro_torch.sim.apps import AppArrays, app_fields, from_numpy, stack_mixes
from repro_torch.sim.managers import MANAGER_NAMES
from repro_torch.sim.runner import CMPConfig, equal_share

_NOT_PORTED = ("is not ported yet: ROADMAP Queue A, item 12 (the segment "
               "backend and param_grid of run_sweep)")


class CapacityInvariantError(RuntimeError):
    """An allocation violated its sums-to-capacity invariant."""


def _check_units_capacity(units: np.ndarray, total_units: int,
                          where: str) -> None:
    sums = np.asarray(units).sum(axis=-1)
    if not (sums == total_units).all():
        raise CapacityInvariantError(
            f"{where}: cache allocation sums {np.unique(sums)} != "
            f"total_cache_units {total_units}")


def _check_bandwidth_capacity(bandwidth: np.ndarray, total_bandwidth: float,
                              where: str) -> None:
    sums = np.asarray(bandwidth).sum(axis=-1)
    if not np.allclose(sums, total_bandwidth, rtol=1e-9, atol=1e-6):
        raise CapacityInvariantError(
            f"{where}: bandwidth allocation sums in "
            f"[{sums.min()}, {sums.max()}] != total_bandwidth "
            f"{total_bandwidth}")


class BatchedCMPPlant:
    """The 16-core CMP interval model over M stacked workload mixes, with
    the profile parameters on ``device`` as ``(M, n)`` float64 tensors."""

    def __init__(self, mixes: Sequence[Sequence[str]],
                 config: Optional[CMPConfig] = None,
                 device: DeviceLike = None):
        self.mixes: List[List[str]] = [list(m) for m in mixes]
        self.apps: AppArrays = stack_mixes(self.mixes)
        self.config = config or CMPConfig()
        backend = self.config.timeline_backend
        if backend == "auto":
            backend = "stacked"
        if backend == "segment":
            raise NotImplementedError(
                f"timeline_backend='segment' {_NOT_PORTED}")
        if backend not in ("stacked", "fused"):
            raise ValueError(f"unknown timeline backend {backend!r}")
        self.timeline_backend = backend
        self.device = resolve_device(device)
        self.params = from_numpy(app_fields(self.apps), self.device)
        self.n_mixes, self.n_clients = np.asarray(self.apps.cpi_base).shape
        self.total_cache_units = self.config.total_cache_units
        self.total_bandwidth = self.config.total_bandwidth


def baseline_ipc_batched(plant: BatchedCMPPlant) -> np.ndarray:
    """Paper baseline per mix: unpartitioned everything, prefetch off."""
    m, n = plant.n_mixes, plant.n_clients
    units, bw = equal_share(n, plant.total_cache_units, plant.total_bandwidth)
    ss = memsys.evaluate(
        plant.params, np.tile(units, (m, 1)).astype(np.float64),
        np.tile(bw, (m, 1)), np.zeros((m, n)),
        cache_partitioned=False, bandwidth_partitioned=False,
        total_cache_units=float(plant.total_cache_units),
        total_bandwidth_gbps=plant.total_bandwidth,
        llc_extra_cycles=plant.config.llc_extra_cycles)
    return ss.ipc.cpu().numpy()


def _family_modes(family: policies.PolicyFamily
                  ) -> Tuple[Mode, Mode, PrefetchMode]:
    """Effective (cache, bandwidth, prefetch) modes of a registry family:
    the classic families carry them; the auction/QoS policies manage cache
    and bandwidth with prefetch off; the banked-bandwidth family keeps the
    equal cache split and runs Algorithm 1; CPpf partitions cache over
    unpartitioned bandwidth with prefetch on."""
    if family.modes is not None:
        return family.modes
    if family.variant == "cppf":
        return (Mode.DYNAMIC, Mode.UNPARTITIONED, PrefetchMode.ON)
    if family.cache_policy != policies.CACHE_LOOKAHEAD:
        return (Mode.DYNAMIC, Mode.DYNAMIC, PrefetchMode.OFF)
    return (Mode.EQUAL, Mode.DYNAMIC, PrefetchMode.OFF)


def _fig8_spec(plant: BatchedCMPPlant, cache_mode: Mode, bw_mode: Mode,
               pf_mode: PrefetchMode, total_ms: float, params: CBPParams,
               name: str = "") -> timeline.TimelineSpec:
    """A Fig. 8 coordinator timeline as a TimelineSpec (mode flags, step-0
    state, schedule)."""
    m, n = plant.n_mixes, plant.n_clients
    units = np.full(n, plant.total_cache_units // n, dtype=np.int64)
    units[: plant.total_cache_units - int(units.sum())] += 1
    if (cache_mode != Mode.DYNAMIC and bw_mode != Mode.DYNAMIC
            and pf_mode != PrefetchMode.DYNAMIC):
        # Fully static managers have no boundaries and a segmentation-
        # invariant time-weighted mean: one segment evaluates the same
        # model once instead of once per interval.
        schedule = [ScheduleSegment("run", total_ms)]
    else:
        schedule = fig8_schedule(total_ms, params,
                                 pf_mode == PrefetchMode.DYNAMIC)
    return timeline.TimelineSpec(
        schedule=schedule,
        variant="fig8",
        cache_dynamic=cache_mode == Mode.DYNAMIC,
        bandwidth_dynamic=bw_mode == Mode.DYNAMIC,
        cache_partitioned=cache_mode != Mode.UNPARTITIONED,
        bandwidth_partitioned=bw_mode != Mode.UNPARTITIONED,
        init_units=np.tile(units, (m, 1)),
        init_bandwidth=np.full((m, n), plant.total_bandwidth / n),
        init_prefetch=np.full((m, n), pf_mode == PrefetchMode.ON,
                              dtype=bool),
        name=name)


def _manager_spec(plant: BatchedCMPPlant, name: str, total_ms: float,
                  params: CBPParams) -> timeline.TimelineSpec:
    """One registered manager as a TimelineSpec (the reference's wiring)."""
    m, n = plant.n_mixes, plant.n_clients
    family = policies.get_family(name)
    if family.variant == "cppf":
        return timeline.TimelineSpec(
            schedule=timeline.cppf_schedule(total_ms, params),
            variant="cppf",
            cache_dynamic=True,
            bandwidth_dynamic=False,
            cache_partitioned=True,
            bandwidth_partitioned=False,
            init_units=np.full((m, n), plant.total_cache_units // n,
                               dtype=np.int64),
            init_bandwidth=np.full((m, n), plant.total_bandwidth / n),
            init_prefetch=np.ones((m, n), dtype=bool),
            name=name)
    cache_mode, bw_mode, pf_mode = _family_modes(family)
    spec = _fig8_spec(plant, cache_mode, bw_mode, pf_mode, total_ms,
                      params, name=name)
    if family.modes is None:
        spec = dataclasses.replace(
            spec, cache_policy=family.cache_policy,
            bw_policy=family.bw_policy,
            bandwidth_banks=family.bandwidth_banks)
    return spec


def _run_managers_stacked(
    plant: BatchedCMPPlant,
    names: Sequence[str],
    total_ms: float,
    params: CBPParams,
) -> Dict[str, Tuple[np.ndarray, Allocation]]:
    """The manager set over every mix as one stacked timeline, with the
    capacity invariants checked per manager."""
    specs = [_manager_spec(plant, name, total_ms, params) for name in names]
    results = timeline.run_timelines(
        plant.params, specs,
        total_units=plant.total_cache_units,
        total_bandwidth=plant.total_bandwidth,
        llc_extra_cycles=plant.config.llc_extra_cycles,
        min_ways=params.min_ways,
        speedup_threshold=params.speedup_threshold,
        min_bandwidth_allocation=params.min_bandwidth_allocation,
        atd_decay=params.atd_decay,
        bandwidth_delay_decay=params.bandwidth_delay_decay,
    )
    out: Dict[str, Tuple[np.ndarray, Allocation]] = {}
    for spec, res in zip(specs, results):
        cache_mode, bw_mode, _pf = _family_modes(
            policies.get_family(spec.name))
        where = f"run_sweep[{spec.name}]"
        if cache_mode == Mode.DYNAMIC:
            _check_units_capacity(
                res.cache_units, plant.total_cache_units, where)
        if bw_mode == Mode.DYNAMIC or spec.variant == "cppf":
            _check_bandwidth_capacity(
                res.bandwidth, plant.total_bandwidth, where)
        alloc = Allocation(
            cache_units=res.cache_units,
            bandwidth=res.bandwidth,
            prefetch_on=res.prefetch_on,
            cache_mode=cache_mode,
            bandwidth_mode=bw_mode,
            bandwidth_banks=spec.bandwidth_banks,
        )
        out[spec.name] = (res.mean_ipc(), alloc)
    return out


@dataclasses.dataclass
class SweepResult:
    """Per-(manager, mix, app) outcome of one sweep, as host arrays."""

    manager_names: List[str]
    mixes: List[List[str]]
    ipc: Dict[str, np.ndarray]            # name -> (M, n)
    final_alloc: Dict[str, Allocation]    # name -> batched allocation
    baseline_ipc: np.ndarray              # (M, n)

    @property
    def n_mixes(self) -> int:
        return len(self.mixes)

    def weighted_speedup(self, name: str) -> np.ndarray:
        """Paper §4.3 weighted speedup per mix, shape (M,)."""
        return np.mean(self.ipc[name] / self.baseline_ipc, axis=-1)

    def antt(self, name: str) -> np.ndarray:
        """Paper §4.3 average normalized turnaround time per mix, (M,)."""
        return np.mean(self.baseline_ipc / self.ipc[name], axis=-1)

    def geomean_speedup(self, name: str) -> float:
        """Geomean of the weighted speedup over mixes."""
        return float(np.exp(np.mean(np.log(self.weighted_speedup(name)))))

    def summary(self) -> Dict[str, float]:
        """Geomean weighted speedup per manager, rounded to 4 places."""
        return {name: round(self.geomean_speedup(name), 4)
                for name in self.manager_names}


def run_sweep(
    mixes: Sequence[Sequence[str]],
    managers: Optional[Sequence[str]] = None,
    total_ms: float = 100.0,
    params: Optional[CBPParams] = None,
    config: Optional[CMPConfig] = None,
    param_grid: Optional[Sequence[CBPParams]] = None,
    device: DeviceLike = None,
) -> SweepResult:
    """Evaluate the registered managers over many mixes on ``device``.

    Args:
      mixes: equal-size workload mixes (lists of app names), e.g.
        :func:`repro_torch.sim.workloads.random_mixes`.
      managers: manager names (default: all ``MANAGER_NAMES``).
      total_ms / params / config: timeline length, CBP tunables and CMP
        configuration, as in the reference.
      param_grid: not ported yet (raises ``NotImplementedError``).
      device: ``None`` runs on the CUDA card and raises without one;
        ``"cpu"`` runs the same code on the CPU.
    """
    if param_grid is not None:
        raise NotImplementedError(f"param_grid {_NOT_PORTED}")
    plant = BatchedCMPPlant(mixes, config, device=device)
    names = list(MANAGER_NAMES) if managers is None else list(managers)
    policies.validate_manager_names(names)
    params = params or CBPParams()
    if plant.timeline_backend == "stacked":
        runs = _run_managers_stacked(plant, names, total_ms, params)
    else:
        runs = {}
        for name in names:
            runs.update(_run_managers_stacked(plant, [name], total_ms,
                                              params))
    return SweepResult(
        manager_names=names,
        mixes=plant.mixes,
        ipc={name: runs[name][0] for name in names},
        final_alloc={name: runs[name][1] for name in names},
        baseline_ipc=baseline_ipc_batched(plant),
    )
