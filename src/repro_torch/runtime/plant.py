"""The training-loop binding: a whole Fig. 8 knob schedule as ONE device
program (counterpart of :mod:`repro.runtime.plant_jax`).

``TrainingPlant`` + the host :class:`~repro_torch.core.coordinator.
CBPCoordinator` pay a host round-trip per schedule segment.  Here the
segment list is encoded as a ``(kinds, durations, reconfigure)`` table
(:func:`repro_torch.sim.timeline.segment_table`) and one body runs every
row: staging-buffer reallocation through the Lookahead greedy
(:func:`~repro_torch.core.cache_controller.lookahead_traced`, the CUDA
kernel on the card), Algorithm-1 bandwidth splits and Algorithm-2 A/B
throttling at the interval boundaries.  The table is on the host, so the
reference's ``lax.cond`` on the reconfigure flag is a Python ``if``.

On a CUDA device the body runs once eagerly as a warm-up and is captured
into one CUDA graph (:class:`repro_torch.graph.CapturedProgram`); every
run with the same key (the model, ``n``, ``U``, the three knob modes and
the segment table, as the reference's ``lru_cache``) is one replay and
one device-to-host copy of the stacked outputs.  The initial allocation
and the six ``CBPParams`` / capacity scalars are static device tensors
filled in place before each replay, so runs whose params share a
schedule share a graph.  On the CPU the same body runs eagerly.

The host pair, ``CBPCoordinator(TrainingPlant(..., step_fn))``
(:func:`host_reference_run`), is the parity golden.  With the step model
of :mod:`repro_torch.train.plant_model` the fused trajectory equals the
reference's golden bit for bit: eager PyTorch rounds every op's result
to float64 (nothing contracts into an FMA), every division is by a
tensor, and the one reduction, Algorithm 1's delay sum, runs in numpy's
order (:func:`numpy_order_sum`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bandwidth_controller import check_bandwidth_floor
from repro_torch.core.cache_controller import lookahead_traced
from repro_torch.core.coordinator import CBPCoordinator, IntervalRecord
from repro_torch.core.dispatch import SCHEDULE_GRAPH_REPLAYS
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.core.types import CBPParams, Mode, PrefetchMode, fig8_schedule
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.graph import CapturedProgram
from repro_torch.numpy_order import numpy_order_sum
from repro_torch.runtime.cbp_runtime import TrainingPlant
from repro_torch.sim.timeline import (
    NOOP,
    RUN,
    SAMPLE_OFF,
    SAMPLE_ON,
    segment_table,
)


@dataclasses.dataclass
class PlantScheduleResult:
    """Per-segment knob trajectory + observations of one run, on the host.

    Rows are the *executed* (non-boundary) segments of the Fig. 8 schedule,
    in order — exactly the rows the host coordinator appends to
    ``history``.  ``kinds`` uses the timeline codes
    (``SAMPLE_OFF/SAMPLE_ON/RUN``).
    """

    kinds: np.ndarray          # (S,) int32 segment kind codes
    t_ms: np.ndarray           # (S,) segment start times
    duration_ms: np.ndarray    # (S,)
    cache_units: np.ndarray    # (S, n) int64 — staging-buffer partitions
    bandwidth: np.ndarray      # (S, n) float64
    prefetch_on: np.ndarray    # (S, n) bool (as applied, incl. A/B forcing)
    ipc: np.ndarray            # (S, n) throughput observed per segment
    queuing_delay_ns: np.ndarray  # (S, n) queue wait observed per segment

    def mean_ipc(self) -> np.ndarray:
        """Time-weighted mean throughput per client (host ``mean_ipc``)."""
        w = self.duration_ms[:, None]
        return (self.ipc * w).sum(axis=0) / max(self.duration_ms.sum(), 1e-12)


def _segment_starts(durations: np.ndarray) -> np.ndarray:
    """Start times by the host coordinator's exact accumulation order."""
    t, starts = 0.0, []
    for d in durations:
        starts.append(t)
        t += float(d)
    return np.array(starts, dtype=np.float64)


def _allocate_bandwidth(delay, total_bw, min_bw, n: int):
    """Algorithm 1 with the delay total in numpy's order; ``total_bw``
    and ``min_bw`` are 0-D tensors on the device (no host copy, and no
    division by a host scalar)."""
    remaining = total_bw - min_bw * n
    total_delay = numpy_order_sum(delay)
    share = torch.where(
        total_delay > 0,
        delay / torch.where(total_delay > 0, total_delay, 1.0),
        1.0 / n)
    return min_bw + share * remaining


def _schedule_body(model: Callable, n: int, total_units: int,
                   cache_dynamic: bool, bandwidth_dynamic: bool,
                   prefetch_dynamic: bool,
                   table: Tuple[Tuple[int, float, bool], ...],
                   units0, bw0, pf0, scalars) -> torch.Tensor:
    """Every row of ``table``, mirroring the reference's scan step: maybe
    reconfigure (cache -> ATD decay -> bandwidth, the paper's priority
    order), force the A/B prefetch setting, evaluate the plant model,
    accumulate the ATD counters and the decayed queuing-delay
    accumulator, and fold the throttle decision after each ``sample_on``
    row.  Reads its inputs from the given tensors only and never
    synchronises with the host, so it can be captured.  Returns ``(S, 5,
    n)`` float64: units, bandwidth, prefetch as applied, throughput and
    queue wait (ns) per row."""
    min_ways, total_bw, min_bw, atd_decay, bw_decay, threshold = scalars
    dev = units0.device
    units, bw, pf = units0, bw0, pf0
    atd = torch.zeros((n, total_units + 1), dtype=F64, device=dev)
    bw_acc = torch.zeros((n,), dtype=F64, device=dev)
    off_ipc = torch.zeros((n,), dtype=F64, device=dev)
    forced = {SAMPLE_OFF: torch.zeros((n,), dtype=torch.bool, device=dev),
              SAMPLE_ON: torch.ones((n,), dtype=torch.bool, device=dev)}
    ys: List[List[torch.Tensor]] = [[], [], [], [], []]
    for kind, dt, reconf in table:
        if reconf:
            if cache_dynamic:
                units = lookahead_traced(
                    atd[None], min_ways.reshape(1),
                    total_units)[0].to(units.dtype)
            atd = atd * atd_decay
            if bandwidth_dynamic:
                bw = _allocate_bandwidth(bw_acc, total_bw, min_bw, n)
        pf_used = forced.get(kind, pf)
        thr, wait, curves = model(dt, units.to(F64), bw, pf_used.to(F64))
        # NOOP rows (trailing-boundary padding) are bitwise no-ops: zero
        # accumulation weight, no controller update.
        w = dt if kind != NOOP else 0.0
        atd = atd + curves * w
        q_ns = wait * 1e6           # TrainingPlant.run_interval's scaling
        if kind != NOOP:
            bw_acc = bw_decay * bw_acc + q_ns * w
        if kind == SAMPLE_OFF:
            off_ipc = thr
        if prefetch_dynamic and kind == SAMPLE_ON:
            pf = throttle_decision(thr, off_ipc, threshold)
        for y, v in zip(ys, (units, bw, pf_used, thr, q_ns)):
            y.append(v)
    return torch.stack([torch.stack(y).to(F64) for y in ys], dim=1)


class ScheduleProgram:
    """One schedule key's static inputs and body; on a CUDA device its
    captured graph (``graph``: its launches per replay and the seconds of
    its warm-up and capture)."""

    def __init__(self, model: Callable, n: int, total_units: int,
                 modes: Tuple[bool, bool, bool],
                 table: Tuple[Tuple[int, float, bool], ...],
                 device: torch.device):
        self.n = n
        # Step 0 (Fig. 8): equal partitions, remainder to the lowest
        # indices — identical to CBPCoordinator._initial_allocation.
        units0 = np.full(n, total_units // n, dtype=np.int64)
        units0[: total_units - int(units0.sum())] += 1
        self.units0 = torch.as_tensor(units0, device=device)
        self.bw0 = torch.empty((n,), dtype=F64, device=device)
        self.pf0 = torch.empty((n,), dtype=torch.bool, device=device)
        self.scalars = (torch.empty((), dtype=torch.int64, device=device),
                        *(torch.empty((), dtype=F64, device=device)
                          for _ in range(5)))
        self._body = functools.partial(
            _schedule_body, model, n, total_units, *modes, table,
            self.units0, self.bw0, self.pf0, self.scalars)
        self.graph = (CapturedProgram(self._body, device,
                                      SCHEDULE_GRAPH_REPLAYS)
                      if device.type == "cuda" else None)

    def run(self, params: CBPParams, total_bandwidth: float,
            prefetch_on: bool) -> np.ndarray:
        """Fill the static inputs in place, run, and copy the ``(S, 5,
        n)`` outputs to the host once."""
        self.bw0.fill_(total_bandwidth / self.n)
        self.pf0.fill_(prefetch_on)
        for t, v in zip(self.scalars, (
                params.min_ways, total_bandwidth,
                params.min_bandwidth_allocation, params.atd_decay,
                params.bandwidth_delay_decay, params.speedup_threshold)):
            t.fill_(v)
        out = self.graph.run() if self.graph is not None else self._body()
        return out.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _schedule_program(model: Callable, n: int, total_units: int,
                      modes: Tuple[bool, bool, bool],
                      table: Tuple[Tuple[int, float, bool], ...],
                      device: torch.device) -> ScheduleProgram:
    return ScheduleProgram(model, n, total_units, modes, table, device)


def schedule_program(
    model: Callable,
    *,
    n_clients: int,
    total_units: int,
    total_bandwidth: float,
    total_ms: float,
    params: Optional[CBPParams] = None,
    cache_mode: Mode = Mode.DYNAMIC,
    bandwidth_mode: Mode = Mode.DYNAMIC,
    prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
    device: DeviceLike = None,
) -> Tuple[ScheduleProgram, np.ndarray, np.ndarray]:
    """The cached program of :func:`run_fused_schedule`'s arguments, and
    the segment table's kinds and durations.

    Feasibility checks (bandwidth floor, ``min_ways`` capacity, schedule
    well-formedness via ``CBPParams``) run here, on the host, before any
    device work.
    """
    params = params or CBPParams()
    n = n_clients
    check_bandwidth_floor(params.min_bandwidth_allocation, n, total_bandwidth)
    if params.min_ways * n > total_units:
        raise ValueError("min_ways * n_clients exceeds total_units")
    schedule = fig8_schedule(total_ms, params,
                             prefetch_mode == PrefetchMode.DYNAMIC)
    kinds, durs, reconf = segment_table(schedule)
    table = tuple(zip(kinds.tolist(), durs.tolist(), reconf.tolist()))
    modes = (cache_mode == Mode.DYNAMIC, bandwidth_mode == Mode.DYNAMIC,
             prefetch_mode == PrefetchMode.DYNAMIC)
    prog = _schedule_program(model, n, int(total_units), modes, table,
                             resolve_device(device))
    return prog, kinds, durs


def run_fused_schedule(
    model: Callable,
    *,
    n_clients: int,
    total_units: int,
    total_bandwidth: float,
    total_ms: float,
    params: Optional[CBPParams] = None,
    cache_mode: Mode = Mode.DYNAMIC,
    bandwidth_mode: Mode = Mode.DYNAMIC,
    prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
    device: DeviceLike = None,
) -> PlantScheduleResult:
    """Run a full Fig. 8 knob schedule as one device program on
    ``device`` (``None``: the card): one CUDA-graph replay per run there,
    the same body eagerly on the CPU.  ``model`` is a ``step_model`` of
    :func:`repro_torch.train.plant_model.make_stream_plant_model` (or any
    model of its signature) on the same device.  The feasibility checks
    run on the host first (:func:`schedule_program`).
    """
    params = params or CBPParams()
    prog, kinds, durs = schedule_program(
        model, n_clients=n_clients, total_units=total_units,
        total_bandwidth=total_bandwidth, total_ms=total_ms, params=params,
        cache_mode=cache_mode, bandwidth_mode=bandwidth_mode,
        prefetch_mode=prefetch_mode, device=device)
    out = prog.run(params, float(total_bandwidth),
                   prefetch_mode == PrefetchMode.ON)
    live = kinds != NOOP
    return PlantScheduleResult(
        kinds=kinds[live],
        t_ms=_segment_starts(durs)[live],
        duration_ms=durs[live],
        cache_units=out[live, 0].astype(np.int64),
        bandwidth=out[live, 1],
        prefetch_on=out[live, 2] != 0,
        ipc=out[live, 3],
        queuing_delay_ns=out[live, 4],
    )


class FusedTrainingPlant:
    """Device-resident sibling of ``TrainingPlant`` + ``CBPCoordinator``.

    Holds the step model and the capacity constants; each ``run`` is one
    device program (one graph replay on the card).  The host pair —
    ``CBPCoordinator(TrainingPlant(..., step_fn))`` — is the parity golden
    (see :func:`host_reference_run`).
    """

    def __init__(self, n_clients: int, total_buffer_units: int,
                 total_bandwidth_mbps: float, step_model: Callable,
                 device: DeviceLike = None):
        self.n_clients = n_clients
        self.total_cache_units = total_buffer_units
        self.total_bandwidth = total_bandwidth_mbps
        self.device = resolve_device(device)
        self._model = step_model

    def run(self, total_ms: float,
            params: Optional[CBPParams] = None,
            cache_mode: Mode = Mode.DYNAMIC,
            bandwidth_mode: Mode = Mode.DYNAMIC,
            prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
            ) -> PlantScheduleResult:
        return run_fused_schedule(
            self._model,
            n_clients=self.n_clients,
            total_units=self.total_cache_units,
            total_bandwidth=self.total_bandwidth,
            total_ms=total_ms,
            params=params,
            cache_mode=cache_mode,
            bandwidth_mode=bandwidth_mode,
            prefetch_mode=prefetch_mode,
            device=self.device)


def host_reference_run(
    step_fn: Callable,
    *,
    n_clients: int,
    total_units: int,
    total_bandwidth: float,
    total_ms: float,
    params: Optional[CBPParams] = None,
    cache_mode: Mode = Mode.DYNAMIC,
    bandwidth_mode: Mode = Mode.DYNAMIC,
    prefetch_mode: PrefetchMode = PrefetchMode.DYNAMIC,
    device: DeviceLike = None,
) -> PlantScheduleResult:
    """The golden path: the port's ``CBPCoordinator`` over its
    ``TrainingPlant`` on ``device`` (``None``: the card), one host
    round-trip per segment, the greedy on the device at every
    reconfiguration.  ``step_fn`` is a ``step_fn`` of
    :func:`repro_torch.train.plant_model.make_stream_plant_model` on the
    same device.

    Returns the knob trajectory in the same shape as
    :func:`run_fused_schedule`.
    """
    params = params or CBPParams()
    plant = TrainingPlant(n_clients, total_units, total_bandwidth, step_fn,
                          device=device)
    coord = CBPCoordinator(plant, params, cache_mode=cache_mode,
                           bandwidth_mode=bandwidth_mode,
                           prefetch_mode=prefetch_mode)
    history = coord.run(total_ms)
    schedule = fig8_schedule(total_ms, params,
                             prefetch_mode == PrefetchMode.DYNAMIC)
    kinds, _durs, _rec = segment_table(schedule)
    return trajectory_from_history(history, kinds[kinds != NOOP])


def _stacked(values: List[torch.Tensor], dtype) -> np.ndarray:
    """Stack per-record tensors on their device, then one host copy."""
    return torch.stack(values).cpu().numpy().astype(dtype, copy=False)


def trajectory_from_history(history: List[IntervalRecord],
                            kinds: Optional[Sequence[int]] = None,
                            ) -> PlantScheduleResult:
    """Convert a host coordinator ``history`` into a trajectory struct."""
    S = len(history)
    kinds = (np.asarray(kinds, dtype=np.int32) if kinds is not None
             else np.full(S, RUN, dtype=np.int32))
    return PlantScheduleResult(
        kinds=kinds,
        t_ms=np.array([r.t_ms for r in history], dtype=np.float64),
        duration_ms=np.array([r.duration_ms for r in history],
                             dtype=np.float64),
        cache_units=_stacked([r.alloc.cache_units for r in history],
                             np.int64),
        bandwidth=_stacked([r.alloc.bandwidth for r in history],
                           np.float64),
        prefetch_on=_stacked([r.alloc.prefetch_on for r in history], bool),
        ipc=_stacked([r.stats.ipc for r in history], np.float64),
        queuing_delay_ns=_stacked([r.stats.queuing_delay_ns
                                   for r in history], np.float64),
    )
