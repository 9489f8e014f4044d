"""The registered manager families on the scalar CMP plant (counterpart of
:mod:`repro.sim.managers`): paper Table 3 plus the registry's related-work
families.

Every manager runs on one :class:`~repro_torch.sim.runner.CMPPlant`: the
Table-3 subset managers reuse :class:`~repro_torch.core.coordinator.
CBPCoordinator` with the unmanaged resources pinned; CPpf (paper §4.4)
pins prefetch-friendly apps at the minimum partition and runs UCP over
the rest; the auction / QoS / banked-bandwidth families run through
:func:`policy_loop`, which the sweep's segment backend reuses over a
leading mix axis.  The loops keep their state as tensors on the plant's
device; results come back to the host.

``MANAGER_NAMES`` and ``TABLE3_MODES`` derive from the registry, and this
module attaches each family's ``host_golden`` at import time, so the
registry itself imports no plant.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.atd import SampledATD
from repro_torch.core.bandwidth_controller import (
    allocate_bandwidth,
    check_bandwidth_floor,
)
from repro_torch.core.cache_controller import CacheController
from repro_torch.core.coordinator import CBPCoordinator
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.core.types import Allocation, CBPParams, Mode, fig8_schedule
from repro_torch.device import F64, DeviceLike, lead_tensor
from repro_torch.sim import policies
from repro_torch.sim.runner import CMPConfig, CMPPlant

#: Every registered family, in registry order.
MANAGER_NAMES = policies.manager_names()

#: (cache_mode, bandwidth_mode, prefetch_mode) of the classic Table-3
#: mode-combination families.
TABLE3_MODES = policies.table3_modes()


@dataclasses.dataclass
class ManagerResult:
    name: str
    ipc: np.ndarray                 # time-weighted mean per-app IPC
    final_alloc: Optional[Allocation] = None


def to_host(alloc: Allocation) -> Allocation:
    """The same allocation with numpy arrays in place of tensors."""
    return dataclasses.replace(alloc, **{
        f: getattr(alloc, f).cpu().numpy()
        for f in ("cache_units", "bandwidth", "prefetch_on")
        if isinstance(getattr(alloc, f), torch.Tensor)})


def run_manager(
    name: str,
    plant: CMPPlant,
    total_ms: float = 100.0,
    params: Optional[CBPParams] = None,
) -> ManagerResult:
    params = params or CBPParams()
    family = policies.get_family(name)   # raises UnknownManagerError
    if family.variant == "cppf":
        ipc, alloc = _run_cppf(plant, total_ms, params)
        return ManagerResult(name="CPpf", ipc=ipc.cpu().numpy(),
                             final_alloc=to_host(alloc))
    if family.modes is None:
        ipc, alloc = policy_loop(plant, family, total_ms, params)
        return ManagerResult(name=name, ipc=ipc.cpu().numpy(),
                             final_alloc=to_host(alloc))
    cache_mode, bw_mode, pf_mode = family.modes
    coord = CBPCoordinator(
        plant, params=params,
        cache_mode=cache_mode, bandwidth_mode=bw_mode, prefetch_mode=pf_mode)
    coord.run(total_ms)
    return ManagerResult(name=name, ipc=coord.mean_ipc(),
                         final_alloc=to_host(coord.alloc))


def policy_loop(
    plant,
    family: policies.PolicyFamily,
    total_ms: float,
    params: CBPParams,
    *,
    min_ways=None,
    min_bandwidth=None,
    atd_decay=None,
    bandwidth_delay_decay=None,
):
    """The registry's policy / banked families on a plant, as the stacked
    timeline runs them (:mod:`repro_torch.sim.timeline`): per executed
    interval the ATD counters accumulate ``curves * dt`` and the delay
    EMA advances by ``decay * acc + q_ns * dt``; the QoS slowdown
    reference is the first executed interval's IPC over the most recent
    one; at each Fig. 8 boundary the family's allocators fire and THEN the
    ATD decays.

    Shape-agnostic over a leading mix axis: ``plant`` is the scalar
    :class:`~repro_torch.sim.runner.CMPPlant` (state ``(n,)``) or the
    sweep's ``BatchedCMPPlant`` (state ``(M, n)``, ``n_mixes`` set), with
    per-row tunables (``min_ways`` ``(M,)``, the others ``(M, 1)`` or
    ``(M, 1, 1)``) for the batched segment path.

    Returns ``(mean_ipc, final Allocation)`` as tensors on the plant's
    device.
    """
    n = plant.n_clients
    total_units = plant.total_cache_units
    total_bw = plant.total_bandwidth
    dev = plant.device
    m = getattr(plant, "n_mixes", None)
    lead = () if m is None else (m,)

    if min_ways is None:
        min_ways = params.min_ways
    if min_bandwidth is None:
        min_bandwidth = params.min_bandwidth_allocation
    if atd_decay is None:
        atd_decay = params.atd_decay
    if bandwidth_delay_decay is None:
        bandwidth_delay_decay = params.bandwidth_delay_decay
    check_bandwidth_floor(min_bandwidth, n, total_bw)
    mw = lead_tensor(min_ways, lead, 1, torch.int64, dev)
    min_bw = lead_tensor(min_bandwidth, lead, 1, F64, dev)
    atd_decay = lead_tensor(atd_decay, lead, 2, F64, dev)
    bw_decay = lead_tensor(bandwidth_delay_decay, lead, 1, F64, dev)

    # auction/qos allocate both resources from their boundary branch;
    # "bank bw" keeps cache at the equal split and runs Algorithm 1
    # under the banked-token memory regime.
    is_policy = family.cache_policy != policies.CACHE_LOOKAHEAD
    cache_mode = Mode.DYNAMIC if is_policy else Mode.EQUAL

    units = np.full(n, total_units // n, dtype=np.int64)
    units[: total_units - int(units.sum())] += 1
    units = torch.as_tensor(np.broadcast_to(units, lead + (n,)).copy(),
                            device=dev)
    bw = torch.full(lead + (n,), total_bw / n, dtype=F64, device=dev)
    pf = torch.zeros(lead + (n,), dtype=torch.bool, device=dev)

    def make_alloc(units, bw):
        return Allocation(
            cache_units=units, bandwidth=bw, prefetch_on=pf,
            cache_mode=cache_mode, bandwidth_mode=Mode.DYNAMIC,
            bandwidth_banks=family.bandwidth_banks)

    atd = torch.zeros(lead + (n, total_units + 1), dtype=F64, device=dev)
    zeros = torch.zeros(lead + (n,), dtype=F64, device=dev)
    bw_acc = ref_ipc = prev_ipc = ipc_acc = zeros
    w_acc = 0.0
    for seg in fig8_schedule(total_ms, params, False):
        if seg.kind == "reconfigure":
            if family.cache_policy == policies.CACHE_AUCTION:
                units, bw = policies.auction_allocate(
                    atd, bw_acc, min_ways=mw, total_units=total_units,
                    min_bandwidth=min_bw, total_bandwidth=total_bw)
            elif family.cache_policy == policies.CACHE_QOS:
                slow = torch.where(
                    prev_ipc > 0,
                    ref_ipc / torch.where(prev_ipc > 0, prev_ipc, 1.0), 1.0)
                units, bw = policies.qos_allocate(
                    atd, bw_acc, slow, min_ways=mw, total_units=total_units,
                    min_bandwidth=min_bw, total_bandwidth=total_bw,
                    bound=policies.QOS_SLOWDOWN_BOUND,
                    gain=policies.QOS_VIOLATION_GAIN)
            else:
                bw = allocate_bandwidth(bw_acc, total_bw, min_bw)
            units = units.to(torch.int64)
            atd = atd * atd_decay
        else:
            dt = seg.duration_ms
            stats = plant.run_interval(make_alloc(units, bw), dt)
            atd = atd + stats.utility_curves * dt
            bw_acc = bw_decay * bw_acc + stats.queuing_delay_ns * dt
            ref_ipc = torch.where(ref_ipc == 0.0, stats.ipc, ref_ipc)
            prev_ipc = stats.ipc
            ipc_acc = ipc_acc + stats.ipc * dt
            w_acc += dt
    return ipc_acc / max(w_acc, 1e-12), make_alloc(units, bw)


def _run_cppf(plant, total_ms: float, params: CBPParams, *,
              min_ways=None, atd_decay=None, speedup_threshold=None):
    """CPpf: prefetch-aware LLC partitioning (paper §4.4): a friendliness
    A/B probe at equal partitioning, then per interval run and reallocate
    (friendly apps at the minimum, UCP for the others over the remaining
    capacity), including after the final interval; bandwidth
    unpartitioned, prefetching enabled.

    Shape-agnostic over a leading mix axis as :func:`policy_loop` is, with
    per-row ``min_ways`` ``(M,)`` and ``atd_decay`` / ``speedup_threshold``
    with trailing singleton axes for the batched segment path; each
    reallocation is one greedy over every row.  Returns ``(mean_ipc, final
    Allocation)`` as tensors."""
    n = plant.n_clients
    total_units = plant.total_cache_units
    dev = plant.device
    m = getattr(plant, "n_mixes", None)
    lead = () if m is None else (m,)
    if min_ways is None:
        min_ways = params.min_ways
    atd_decay = lead_tensor(params.atd_decay if atd_decay is None
                            else atd_decay, lead, 2, F64, dev)
    threshold = lead_tensor(params.speedup_threshold if speedup_threshold
                            is None else speedup_threshold, lead, 1, F64, dev)
    atd = SampledATD(n, total_units, device=dev, batch_shape=lead)
    cache_ctl = CacheController(total_units, params.min_ways,
                                backend=plant.allocator_backend)

    equal_units = torch.full(lead + (n,), total_units // n,
                             dtype=torch.int64, device=dev)
    bw = torch.full(lead + (n,), plant.total_bandwidth / n, dtype=F64,
                    device=dev)

    def make_alloc(units, pf_on) -> Allocation:
        return Allocation(
            cache_units=units, bandwidth=bw.clone(), prefetch_on=pf_on,
            cache_mode=Mode.DYNAMIC, bandwidth_mode=Mode.UNPARTITIONED)

    off = plant.run_interval(
        make_alloc(equal_units, torch.zeros(lead + (n,), dtype=torch.bool,
                                            device=dev)),
        params.prefetch_sampling_period_ms)
    on = plant.run_interval(
        make_alloc(equal_units, torch.ones(lead + (n,), dtype=torch.bool,
                                           device=dev)),
        params.prefetch_sampling_period_ms)
    friendly = throttle_decision(on.ipc, off.ipc, threshold)

    # Table 3: prefetching enabled.
    pf_on = torch.ones(lead + (n,), dtype=torch.bool, device=dev)
    units = equal_units.clone()
    t = 0.0
    ipc_acc = torch.zeros(lead + (n,), dtype=F64, device=dev)
    w_acc = 0.0
    while t < total_ms - 1e-9:
        dt = min(params.reconfiguration_interval_ms, total_ms - t)
        stats = plant.run_interval(make_alloc(units, pf_on), dt)
        atd.record(stats.utility_curves * dt)
        ipc_acc = ipc_acc + stats.ipc * dt
        w_acc += dt
        t += dt
        curves = atd.utility_curves()
        atd.halve(atd_decay)
        units = cache_ctl.allocate_masked(curves, ~friendly,
                                          min_units=min_ways)
    return ipc_acc / w_acc, make_alloc(units, pf_on)


def run_all_managers(
    workload: Sequence[str],
    total_ms: float = 100.0,
    names: Optional[List[str]] = None,
    params: Optional[CBPParams] = None,
    config: Optional[CMPConfig] = None,
    device: DeviceLike = None,
) -> Dict[str, ManagerResult]:
    """Every named manager (default: all) on one mix's plant on
    ``device`` (``None``: the card)."""
    plant = CMPPlant(workload, config, device=device)
    return {
        name: run_manager(name, plant, total_ms, params)
        for name in (names or MANAGER_NAMES)
    }


# Attach every family's scalar loop to the registry (the registry module
# imports no plant, so the binding happens here).
for _name in policies.manager_names():
    _fam = policies.get_family(_name)
    if _fam.host_golden is None:
        _fam.host_golden = functools.partial(run_manager, _name)
del _name, _fam
