"""The Table-3 sweep: every manager family over many mixes (counterpart of
:mod:`repro.sim.sweep`, the paper's Figs. 9-12 evaluation substrate).

:func:`run_sweep` builds one :class:`~repro_torch.sim.timeline.
TimelineSpec` per manager (:func:`_manager_spec`, the same wiring as the
reference), runs the whole set as one stacked timeline on the device
(:func:`repro_torch.sim.timeline.run_timelines`) and turns the mean IPC
into weighted speedup against the shared equal-share baseline
(:func:`baseline_ipc_batched`).

Backends (``CMPConfig.timeline_backend``): ``"stacked"`` runs all
managers in one stacked timeline; ``"fused"`` runs the same specs one
manager at a time, the reference the stacked run equals bit for bit;
``"segment"`` is the host loop of one model evaluation per Fig. 8
segment (:class:`BatchedCoordinator` and the scalar plant's CPpf and
policy loops, :mod:`repro_torch.sim.managers`, over a leading mix axis),
with the controllers' state as tensors on the device between them.  It
is the only backend that honours the host allocator
(``allocator_backend="numpy"``), and ``"auto"`` picks it then.

``param_grid=`` adds a leading ``CBPParams`` axis (the Fig. 12 design
space): params that share a Fig. 8 schedule run as one batch of P_g x M
rows with per-row tunables (:func:`_per_row_params`), and managers no
parameter can change run once and are broadcast over P.

Structure:

* :class:`BatchedCMPPlant` — the interval model over M stacked mixes;
  ``run_interval`` takes (M, n) allocation tensors and returns (M, n)
  stats and (M, n, U+1) utility curves.
* :class:`BatchedCoordinator` — :class:`~repro_torch.core.coordinator.
  CBPCoordinator` on the batched plant, with per-row tunables.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.coordinator import TUNABLES, CBPCoordinator
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
from repro_torch.sim.managers import (
    MANAGER_NAMES,
    _run_cppf,
    policy_loop,
    to_host,
)
from repro_torch.sim.runner import (
    CMPConfig,
    CMPPlant,
    _resolve_allocator_backend,
    _resolve_timeline_backend,
    equal_share,
)


class CapacityInvariantError(RuntimeError):
    """An allocation violated its sums-to-capacity invariant."""


def _check_units_capacity(units, total_units: int, where: str) -> None:
    sums = np.asarray(units).sum(axis=-1)
    if not (sums == total_units).all():
        raise CapacityInvariantError(
            f"{where}: cache allocation sums {np.unique(sums)} != "
            f"total_cache_units {total_units}")


def _check_bandwidth_capacity(bandwidth, total_bandwidth: float,
                              where: str) -> None:
    sums = np.asarray(bandwidth).sum(axis=-1)
    if not np.allclose(sums, total_bandwidth, rtol=1e-9, atol=1e-6):
        raise CapacityInvariantError(
            f"{where}: bandwidth allocation sums in "
            f"[{sums.min()}, {sums.max()}] != total_bandwidth "
            f"{total_bandwidth}")


class BatchedCMPPlant(CMPPlant):
    """The 16-core CMP interval model over M stacked workload mixes, with
    the profile parameters on ``device`` as ``(M, n)`` float64 tensors;
    ``evaluate`` / ``run_interval`` (the scalar plant's) broadcast over
    the mix axis."""

    def __init__(self, mixes: Sequence[Sequence[str]],
                 config: Optional[CMPConfig] = None,
                 device: DeviceLike = None):
        self.mixes: List[List[str]] = [list(m) for m in mixes]
        self.apps: AppArrays = stack_mixes(self.mixes)
        self.config = config or CMPConfig()
        # "auto" keeps allocation on the device, and "auto" timelines
        # stack the manager set — unless the allocator was forced onto
        # the host, which only the segment loop can honour.
        self.allocator_backend = _resolve_allocator_backend(self.config)
        self.timeline_backend = _resolve_timeline_backend(
            self.config,
            default="stacked" if self.allocator_backend == "device"
            else "segment")
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


@dataclasses.dataclass
class RowParams:
    """Per-batch-row ``CBPParams`` tunables, broadcast-ready.

    ``schedule`` carries the schedule-shaping fields (common to the whole
    batch); the five other tunables are scalars without ``params_rows``
    and per-row arrays with it — min_ways ``(M,)``, speedup_threshold /
    min_bandwidth_allocation / bandwidth_delay_decay ``(M, 1)`` (against
    (M, n) state) and atd_decay ``(M, 1, 1)`` (against the (M, n, U+1)
    ATD counters).  The stacked timeline takes each as one value per mix
    whatever its trailing axes.
    """

    schedule: CBPParams
    min_ways: object
    speedup_threshold: object
    min_bandwidth_allocation: object
    atd_decay: object
    bandwidth_delay_decay: object

    def tunables(self) -> dict:
        """The five tunables as ``run_timelines`` keyword arguments."""
        return {f: getattr(self, f) for f in TUNABLES}


def _per_row_params(
    params: CBPParams,
    params_rows: Optional[Sequence[CBPParams]],
    n_rows: int,
) -> RowParams:
    """Resolve the per-row tunables of a (possibly params-batched) sweep.

    With ``params_rows`` the non-schedule tunables become per-row arrays;
    the schedule-shaping fields must agree across rows because every batch
    row executes the same Fig. 8 segment list in lockstep.
    """
    if params_rows is None:
        return RowParams(
            schedule=params,
            min_ways=params.min_ways,
            speedup_threshold=params.speedup_threshold,
            min_bandwidth_allocation=params.min_bandwidth_allocation,
            atd_decay=params.atd_decay,
            bandwidth_delay_decay=params.bandwidth_delay_decay,
        )
    rows = list(params_rows)
    if len(rows) != n_rows:
        raise ValueError(
            f"params_rows has {len(rows)} entries for {n_rows} batch rows")
    sched = {(p.reconfiguration_interval_ms, p.prefetch_sampling_period_ms)
             for p in rows}
    if len(sched) > 1:
        raise ValueError(
            "params_rows must share reconfiguration_interval_ms and "
            "prefetch_sampling_period_ms (the Fig. 8 schedule is common to "
            f"the whole batch); got {sorted(sched)}")
    return RowParams(
        schedule=rows[0],
        min_ways=np.array([p.min_ways for p in rows], dtype=np.int64),
        speedup_threshold=np.array(
            [p.speedup_threshold for p in rows])[:, None],
        min_bandwidth_allocation=np.array(
            [p.min_bandwidth_allocation for p in rows])[:, None],
        atd_decay=np.array([p.atd_decay for p in rows])[:, None, None],
        bandwidth_delay_decay=np.array(
            [p.bandwidth_delay_decay for p in rows])[:, None],
    )


class BatchedCoordinator(CBPCoordinator):
    """One Table-3 manager, coordinated across all mixes in lockstep.

    :class:`~repro_torch.core.coordinator.CBPCoordinator` over the batched
    plant (its loop is shape-agnostic over the mix axis): ATD counters (M,
    n, U+1), the delay accumulator over (M, n) delays, the prefetch A/B
    decision elementwise, per-row tunables from ``params_rows``.  All
    mixes share one Fig. 8 timeline, which is what makes lockstep exact.
    Cache allocation is one batched greedy per reconfiguration boundary
    (:class:`~repro_torch.core.cache_controller.CacheController` with the
    plant's allocator backend).
    """

    def __init__(
        self,
        plant: BatchedCMPPlant,
        params: Optional[CBPParams] = None,
        cache_mode: Mode = Mode.DYNAMIC,
        bandwidth_mode: Mode = Mode.DYNAMIC,
        prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
        params_rows: Optional[Sequence[CBPParams]] = None,
    ):
        self.rows = _per_row_params(params or CBPParams(), params_rows,
                                    plant.n_mixes)
        super().__init__(plant, self.rows.schedule, cache_mode,
                         bandwidth_mode, prefetch_mode,
                         tunables=self.rows.tunables())

    def run(self, total_ms: float) -> None:
        """Execute the Fig. 8 timeline over every batch row: on the
        "segment" backend as the coordinator's host loop of one model
        evaluation per segment, otherwise as one stacked timeline of one
        manager.  Both run the same
        :func:`~repro_torch.core.types.fig8_schedule` segment list."""
        if self.plant.timeline_backend == "segment":
            super().run(total_ms)
        else:
            self._run_fused(total_ms)
        if self.cache_mode == Mode.DYNAMIC:
            _check_units_capacity(
                self.alloc.cache_units.cpu().numpy(),
                self.plant.total_cache_units, "BatchedCoordinator.run")
        if self.bandwidth_mode == Mode.DYNAMIC:
            _check_bandwidth_capacity(
                self.alloc.bandwidth.cpu().numpy(),
                self.plant.total_bandwidth, "BatchedCoordinator.run")

    def _run_fused(self, total_ms: float) -> None:
        spec = _fig8_spec(self.plant, self.cache_mode, self.bandwidth_mode,
                          self.prefetch_mode, total_ms, self.params)
        res = _timelines(self.plant, [spec], self.rows)[0]
        dev = self.plant.device
        self._ipc_acc = torch.as_tensor(res.ipc_acc, device=dev)
        self._w_acc = res.w_acc
        self.alloc.cache_units = torch.as_tensor(res.cache_units, device=dev)
        self.alloc.bandwidth = torch.as_tensor(res.bandwidth, device=dev)
        self.alloc.prefetch_on = torch.as_tensor(res.prefetch_on, device=dev)


def _run_one_manager(
    plant: BatchedCMPPlant,
    name: str,
    total_ms: float,
    params: CBPParams,
    params_rows: Optional[Sequence[CBPParams]] = None,
) -> Tuple[np.ndarray, Allocation]:
    """One manager over every batch row of ``plant`` on the segment
    backend -> ((M, n) mean ipc, host allocation).  The scalar loops are
    shape-agnostic, with the per-row tunables threaded through."""
    family = policies.get_family(name)
    if family.modes is not None:
        cache_mode, bw_mode, pf_mode = family.modes
        coord = BatchedCoordinator(
            plant, params=params, cache_mode=cache_mode,
            bandwidth_mode=bw_mode, prefetch_mode=pf_mode,
            params_rows=params_rows)
        coord.run(total_ms)
        return coord.mean_ipc(), to_host(coord.alloc)
    rows = _per_row_params(params, params_rows, plant.n_mixes)
    if family.variant == "cppf":
        ipc, alloc = _run_cppf(
            plant, total_ms, rows.schedule, min_ways=rows.min_ways,
            atd_decay=rows.atd_decay,
            speedup_threshold=rows.speedup_threshold)
    else:
        ipc, alloc = policy_loop(
            plant, family, total_ms, rows.schedule,
            min_ways=rows.min_ways,
            min_bandwidth=rows.min_bandwidth_allocation,
            atd_decay=rows.atd_decay,
            bandwidth_delay_decay=rows.bandwidth_delay_decay)
    alloc = to_host(alloc)
    where = f"run_sweep[{name}]"
    cache_mode, bw_mode, _pf = _family_modes(family)
    if cache_mode == Mode.DYNAMIC:
        _check_units_capacity(alloc.cache_units, plant.total_cache_units,
                              where)
    if bw_mode == Mode.DYNAMIC or family.variant == "cppf":
        _check_bandwidth_capacity(alloc.bandwidth, plant.total_bandwidth,
                                  where)
    return ipc.cpu().numpy(), alloc


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


def _timelines(plant: BatchedCMPPlant, specs, rows: RowParams):
    """``run_timelines`` of ``specs`` on the plant, with its tunables."""
    return timeline.run_timelines(
        plant.params, specs,
        total_units=plant.total_cache_units,
        total_bandwidth=plant.total_bandwidth,
        llc_extra_cycles=plant.config.llc_extra_cycles,
        **rows.tunables())


def _run_managers_stacked(
    plant: BatchedCMPPlant,
    names: Sequence[str],
    total_ms: float,
    params: CBPParams,
    params_rows: Optional[Sequence[CBPParams]] = None,
) -> Dict[str, Tuple[np.ndarray, Allocation]]:
    """The manager set over every batch row as one stacked timeline, with
    the capacity invariants checked per manager."""
    rows = _per_row_params(params, params_rows, plant.n_mixes)
    specs = [_manager_spec(plant, name, total_ms, rows.schedule)
             for name in names]
    results = _timelines(plant, specs, rows)
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


def _run_managers(
    plant: BatchedCMPPlant,
    names: Sequence[str],
    total_ms: float,
    params: CBPParams,
    params_rows: Optional[Sequence[CBPParams]] = None,
) -> Dict[str, Tuple[np.ndarray, Allocation]]:
    """Dispatch a manager set to the plant's timeline backend: "stacked"
    runs every manager in one stacked timeline, "fused" the same specs one
    manager at a time, "segment" the host loop per manager."""
    if plant.timeline_backend == "segment":
        return {name: _run_one_manager(plant, name, total_ms, params,
                                       params_rows)
                for name in names}
    if plant.timeline_backend == "stacked" and names:
        return _run_managers_stacked(
            plant, names, total_ms, params, params_rows)
    out: Dict[str, Tuple[np.ndarray, Allocation]] = {}
    for name in names:
        out.update(_run_managers_stacked(
            plant, [name], total_ms, params, params_rows))
    return out


@dataclasses.dataclass
class SweepResult:
    """Per-(manager, mix, app) outcome of one sweep, as host arrays.

    Without ``param_grid`` the arrays are (M, n); with it they gain a
    leading params axis, (P, M, n), and the metric helpers broadcast
    accordingly (``weighted_speedup`` -> (P, M), ``geomean_speedup`` ->
    (P,)).  The baseline is parameter-independent and stays (M, n).
    """

    manager_names: List[str]
    mixes: List[List[str]]
    ipc: Dict[str, np.ndarray]            # name -> (M, n) | (P, M, n)
    final_alloc: Dict[str, Allocation]    # name -> batched allocation
    baseline_ipc: np.ndarray              # (M, n)
    param_grid: Optional[List[CBPParams]] = None

    @property
    def n_mixes(self) -> int:
        return len(self.mixes)

    def weighted_speedup(self, name: str) -> np.ndarray:
        """Paper §4.3 weighted speedup per mix, shape (M,) (or (P, M))."""
        return np.mean(self.ipc[name] / self.baseline_ipc, axis=-1)

    def antt(self, name: str) -> np.ndarray:
        """Paper §4.3 avg normalized turnaround time per mix, (M,)/(P, M)."""
        return np.mean(self.baseline_ipc / self.ipc[name], axis=-1)

    def geomean_speedup(self, name: str):
        """Geomean over mixes: float, or (P,) with a ``param_grid``."""
        g = np.exp(np.mean(np.log(self.weighted_speedup(name)), axis=-1))
        return float(g) if np.ndim(g) == 0 else g

    def summary(self) -> Dict[str, object]:
        """Geomean weighted speedup per manager, rounded to 4 places."""
        out: Dict[str, object] = {}
        for name in self.manager_names:
            g = self.geomean_speedup(name)
            out[name] = (round(g, 4) if np.ndim(g) == 0
                         else [round(float(x), 4) for x in np.asarray(g)])
        return out


def _params_static(name: str) -> bool:
    """True when no CBPParams field can change the manager's result:
    nothing dynamic means no reconfiguration, no A/B sampling, and a
    time-weighted mean that is segmentation-invariant."""
    family = policies.get_family(name)
    if family.modes is None:
        # CPpf and the registry policy / banked families all manage at
        # least one resource dynamically.
        return False
    cm, bm, pm = family.modes
    return (cm != Mode.DYNAMIC and bm != Mode.DYNAMIC
            and pm != PrefetchMode.DYNAMIC)


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
      param_grid: optional sequence of ``CBPParams``; adds a leading P
        axis to the results (the Fig. 12 design space as one sweep).
        Params sharing a Fig. 8 schedule run as one batch of P_g x M
        rows; schedule-distinct params run as separate batches.  Mutually
        exclusive with ``params``.
      device: ``None`` runs on the CUDA card and raises without one;
        ``"cpu"`` runs the same code on the CPU.
    """
    plant = BatchedCMPPlant(mixes, config, device=device)
    names = list(MANAGER_NAMES) if managers is None else list(managers)
    policies.validate_manager_names(names)

    if param_grid is None:
        runs = _run_managers(plant, names, total_ms, params or CBPParams())
        return SweepResult(
            manager_names=names,
            mixes=plant.mixes,
            ipc={name: runs[name][0] for name in names},
            final_alloc={name: runs[name][1] for name in names},
            baseline_ipc=baseline_ipc_batched(plant),
        )

    if params is not None:
        raise ValueError("pass either params or param_grid, not both")
    grid = list(param_grid)
    if not grid:
        raise ValueError("param_grid must be non-empty")
    P, M, n = len(grid), plant.n_mixes, plant.n_clients
    ipc = {name: np.empty((P, M, n)) for name in names}
    units = {name: np.empty((P, M, n), dtype=np.int64) for name in names}
    bws = {name: np.empty((P, M, n)) for name in names}
    pfs = {name: np.empty((P, M, n), dtype=bool) for name in names}
    modes: Dict[str, Tuple[Mode, Mode]] = {}

    def store(name, idxs, mipc, alloc):
        shape = (len(idxs), M, n)
        ipc[name][idxs] = np.asarray(mipc).reshape(shape)
        units[name][idxs] = np.asarray(alloc.cache_units).reshape(shape)
        bws[name][idxs] = np.asarray(alloc.bandwidth).reshape(shape)
        pfs[name][idxs] = np.asarray(alloc.prefetch_on).reshape(shape)
        modes[name] = (alloc.cache_mode, alloc.bandwidth_mode)

    # Params-static managers run once and are broadcast over P.
    static_names = [name for name in names if _params_static(name)]
    for name, (mipc, alloc) in _run_managers(
            plant, static_names, total_ms, grid[0]).items():
        store(name, list(range(P)), np.broadcast_to(mipc, (P, M, n)),
              dataclasses.replace(alloc, **{
                  f: np.broadcast_to(getattr(alloc, f), (P, M, n))
                  for f in ("cache_units", "bandwidth", "prefetch_on")}))
    grid_names = [name for name in names if name not in static_names]

    groups: Dict[Tuple[float, float], List[int]] = {}
    for pi, p in enumerate(grid):
        key = (p.reconfiguration_interval_ms, p.prefetch_sampling_period_ms)
        groups.setdefault(key, []).append(pi)

    for idxs in (groups.values() if grid_names else ()):
        gplant = BatchedCMPPlant([mix for _ in idxs for mix in plant.mixes],
                                 config, device=plant.device)
        rows = [grid[pi] for pi in idxs for _ in range(M)]
        for name, (mipc, alloc) in _run_managers(
                gplant, grid_names, total_ms, rows[0],
                params_rows=rows).items():
            store(name, idxs, mipc, alloc)

    final = {
        name: Allocation(
            cache_units=units[name], bandwidth=bws[name],
            prefetch_on=pfs[name], cache_mode=modes[name][0],
            bandwidth_mode=modes[name][1])
        for name in names
    }
    return SweepResult(
        manager_names=names,
        mixes=plant.mixes,
        ipc=ipc,
        final_alloc=final,
        baseline_ipc=baseline_ipc_batched(plant),
        param_grid=grid,
    )
