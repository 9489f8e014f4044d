"""Stacked Fig. 8 timelines: the whole manager set in one run
(counterpart of :mod:`repro.sim.timeline_jax`).

Every manager keeps its own segment table (:func:`segment_table`); the
tables stack along a leading manager axis (:func:`stack_tables`, shorter
tables padded with frozen ``NOOP`` slots) and the per-manager knob flags
become per-row data.  The run is a Python loop over the ``S`` slots of the
stacked ``(K, S)`` table, on ``(K*M, n)`` row tensors that stay on the
device; the table is uploaded once.

Because the table is built on the host, everything the JAX scan decides
with traced control flow is decided here on the host, with no device
synchronisation inside the loop: whether a slot reconfigures at all
(``lax.cond`` there), which managers' blocks the boundary greedy gathers
(the ``argsort`` of the realloc mask) and which boundary branch each
manager takes (the ``lax.switch`` on its policy id).  Only the Lookahead
managers' blocks reach the greedy, concatenated into one ``(G*M, n,
U+1)`` launch per boundary; the auction and QoS families take their own
allocators.

Stacking is exact: rows never interact, the model runs on flat ``(K*M,
n)`` rows, and ``NOOP`` slots are bitwise no-ops for a manager's state,
so each manager's rows equal its standalone (``K = 1``) run bit for bit
(``tests/test_torch_sweep.py``).  The managers are stacked in buckets of
equal table length (:func:`_length_buckets`, the JAX program's frozen-row
skipping): each bucket over its own slot count, the buckets sharing one
slot loop, in which a slot evaluates only the buckets still running.  By
the same argument the buckets equal a single stacked table bit for bit
(``tests/test_torch_segment.py`` forces one bucket to compare).
:func:`run_timelines_async` leaves the results on the device
(:class:`PendingTimelines`, with a CUDA event on the card), which is what
lets the streaming sweep generate the next chunk meanwhile.  Single
device only; sharding is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bandwidth_controller import (
    allocate_bandwidth,
    check_bandwidth_floor,
)
from repro_torch.core.cache_controller import lookahead_masked_traced
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.core.types import ScheduleSegment
from repro_torch.device import F64
from repro_torch.sim import memsys, policies
from repro_torch.sim.memsys import FIXED_POINT_ITERS, FREQ_GHZ

#: Segment kinds of the stacked table.  ``NOOP`` rows freeze a manager:
#: the zero-weight model evaluation never accumulates and no controller
#: fires.  They carry a trailing reconfigure boundary (CPpf reallocates
#: after its final interval) and pad shorter tables.
SAMPLE_OFF, SAMPLE_ON, RUN, NOOP = 0, 1, 2, 3

_KIND_CODES = {"sample_off": SAMPLE_OFF, "sample_on": SAMPLE_ON, "run": RUN}


def segment_table(
    schedule: Sequence[ScheduleSegment],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode a segment list as (kinds, durations_ms, reconfigure_flags).

    ``reconfigure`` boundaries are zero-duration in the schedule; folding
    each into the next segment's flag keeps the scan length equal to the
    number of *intervals actually executed* and lets one scan step be
    "maybe reconfigure, then run the segment".
    """
    rows: List[Tuple[int, float, bool]] = []
    pending = False
    for seg in schedule:
        if seg.kind == "reconfigure":
            pending = True
            continue
        rows.append((_KIND_CODES[seg.kind], seg.duration_ms, pending))
        pending = False
    if pending:
        rows.append((NOOP, 0.0, True))
    if not rows:
        raise ValueError("cannot fuse an empty schedule")
    kinds = np.array([r[0] for r in rows], dtype=np.int32)
    durations = np.array([r[1] for r in rows], dtype=np.float64)
    reconf = np.array([r[2] for r in rows], dtype=bool)
    return kinds, durations, reconf


def cppf_schedule(total_ms: float, params) -> List[ScheduleSegment]:
    """CPpf's timeline as data (mirrors ``managers._run_cppf``).

    An A/B friendliness probe at equal partitioning (excluded from the
    time-weighted mean), then per reconfiguration interval: run, then
    reallocate — including after the final interval, which is why the
    segment list *ends* with a reconfigure boundary.
    """
    p = params.prefetch_sampling_period_ms
    segments = [ScheduleSegment("sample_off", p),
                ScheduleSegment("sample_on", p)]
    t = 0.0
    while t < total_ms - 1e-9:
        dt = min(params.reconfiguration_interval_ms, total_ms - t)
        segments.append(ScheduleSegment("run", dt))
        segments.append(ScheduleSegment("reconfigure", 0.0))
        t += dt
    return segments


@dataclasses.dataclass
class TimelineSpec:
    """One manager's timeline + knobs inside a stacked run.

    ``init_units`` / ``init_bandwidth`` / ``init_prefetch`` are the
    ``(M, n)`` step-0 state; the booleans are the Table-3 mode flags,
    which ride the manager axis as per-row data.

    ``cache_policy`` / ``bw_policy`` select the family's boundary
    allocator branch (:data:`repro_torch.sim.policies.CACHE_POLICY_NAMES`
    / :data:`~repro_torch.sim.policies.BW_POLICY_NAMES`; 0 = the classic
    Lookahead / Algorithm-1 pair).  ``bandwidth_banks > 1`` evaluates the
    row under the banked-token memory regime.  ``qos_bound`` /
    ``qos_gain`` parameterize the QoS branch (ignored elsewhere).
    """

    schedule: Sequence[ScheduleSegment]
    variant: str                       # "fig8" | "cppf"
    cache_dynamic: bool
    bandwidth_dynamic: bool
    cache_partitioned: bool
    bandwidth_partitioned: bool
    init_units: np.ndarray
    init_bandwidth: np.ndarray
    init_prefetch: np.ndarray
    name: str = ""
    cache_policy: int = policies.CACHE_LOOKAHEAD
    bw_policy: int = policies.BW_ALG1
    bandwidth_banks: int = 1
    qos_bound: float = policies.QOS_SLOWDOWN_BOUND
    qos_gain: float = policies.QOS_VIOLATION_GAIN

    def __post_init__(self):
        if self.variant not in ("fig8", "cppf"):
            raise ValueError(f"unknown timeline variant {self.variant!r}")
        if not 0 <= self.cache_policy < len(policies.CACHE_POLICY_NAMES):
            raise ValueError(
                f"cache_policy {self.cache_policy} has no traced branch "
                f"(table: {policies.CACHE_POLICY_NAMES})")
        if not 0 <= self.bw_policy < len(policies.BW_POLICY_NAMES):
            raise ValueError(
                f"bw_policy {self.bw_policy} has no traced branch "
                f"(table: {policies.BW_POLICY_NAMES})")
        if self.bandwidth_banks < 1:
            raise ValueError("bandwidth_banks must be >= 1")
        if (self.cache_policy or self.bw_policy) and not (
                self.cache_dynamic and self.bandwidth_dynamic):
            raise ValueError(
                "policy-branch rows must be cache_dynamic and "
                "bandwidth_dynamic (the branch fires at reconfigure "
                "boundaries gated by those flags)")
        if self.cache_policy != self.bw_policy:
            raise ValueError(
                "cache_policy and bw_policy must select the same branch: "
                "a boundary branch allocates both resources from the same "
                "signals (register a combined branch for mixed pairs)")


def stack_tables(
    tables: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    accumulate_kinds: Sequence[Optional[int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-manager segment tables into (K, S) arrays.

    Any order-preserving injection of a manager's rows into the unified
    slot axis is exact: batch rows never interact, and the frozen ``NOOP``
    slots between a manager's rows are bitwise no-ops for its scan state.
    This placement exploits that freedom twice:

    * shorter tables right-pad with ``NOOP`` slots (zero duration, no
      reconfigure);
    * reconfigure-carrying rows snap onto the *longest* table's
      reconfigure slots whenever the ordering allows, so the stacked
      program fires its (batch-wide) Lookahead greedy at as few slots as
      possible — e.g. the Table-3 set's non-sampling managers and CPpf
      reallocate on the same slots as the sampling managers, so one
      Lookahead launch serves them all.

    ``accumulate_kinds[k]`` restricts manager k's accumulation weight to
    one segment kind (CPpf's probe intervals are outside the measured
    window: only ``RUN`` accumulates); ``None`` accumulates every row.
    """
    lens = [len(t[0]) for t in tables]
    s_max = max(lens)
    host_reconf = np.flatnonzero(tables[int(np.argmax(lens))][2])
    K = len(tables)
    kinds = np.full((K, s_max), NOOP, dtype=np.int32)
    acc = np.zeros((K, s_max), dtype=np.float64)
    reconf = np.zeros((K, s_max), dtype=bool)
    for k, ((kk, dd, rr), only) in enumerate(zip(tables, accumulate_kinds)):
        L = len(kk)
        s = 0
        for j in range(L):
            sj = s
            if rr[j]:
                # Snap to the next shared reconfigure slot if one fits
                # before the remaining rows run out of room.
                cand = host_reconf[(host_reconf >= s)
                                   & (host_reconf <= s_max - (L - j))]
                if cand.size:
                    sj = int(cand[0])
            kinds[k, sj] = kk[j]
            acc[k, sj] = (dd[j] if only is None or kk[j] == only else 0.0)
            reconf[k, sj] = rr[j]
            s = sj + 1
    return kinds, acc, reconf


@dataclasses.dataclass
class TimelineResult:
    """Final state of one manager's timeline over M mixes (host arrays)."""

    ipc_acc: np.ndarray        # (M, n) time-weighted IPC sum
    w_acc: float               # accumulated weight (ms) — static per table
    cache_units: np.ndarray    # (M, n) int64 final allocation
    bandwidth: np.ndarray      # (M, n) final bandwidth split
    prefetch_on: np.ndarray    # (M, n) bool final prefetcher setting
    active: np.ndarray         # (M, n) bool CPpf competing mask (fig8: all)

    def mean_ipc(self) -> np.ndarray:
        return self.ipc_acc / max(self.w_acc, 1e-12)


def _per_mix(value, M: int, dtype) -> np.ndarray:
    """A scalar or per-mix tunable as an ``(M, 1)`` array.  A per-mix
    value may carry trailing singleton axes (``RowParams``' ``(M, 1)`` and
    ``(M, 1, 1)``): one value per mix either way."""
    arr = np.asarray(value, dtype=dtype)
    if arr.ndim:
        arr = arr.reshape(M)[:, None]
    return np.broadcast_to(arr, (M, 1))


def _length_buckets(lens: Sequence[int]) -> List[List[int]]:
    """Group manager indices for the bucketed stacked run (copy of the
    reference's rule): managers share a bucket exactly when their segment
    tables have the same length, so a bucket holds no frozen ``NOOP``
    padding, and same-length Table-3 tables share their reconfigure
    slots, so a bucket's boundary greedies merge into one launch.  Stable:
    equal lengths keep spec order."""
    order = sorted(range(len(lens)), key=lambda i: (lens[i], i))
    buckets: List[List[int]] = []
    for i in order:
        if buckets and lens[i] == lens[buckets[-1][0]]:
            buckets[-1].append(i)
        else:
            buckets.append([i])
    return buckets


@dataclasses.dataclass
class PendingTimelines:
    """A stacked-timeline run whose results are still on the device.

    ``device_results`` holds per spec a dict of ``(M, n)`` device tensors
    (views into the stacked state), ``w_accs`` each spec's accumulated
    weight.  On the card ``event`` is a CUDA event recorded after the
    run's last operation on the current stream; nothing waits until
    :meth:`block_until_ready` or :meth:`result`, so the caller can do host
    work (generate the next chunk of a stream) while the card runs.
    """

    device_results: List[Dict[str, torch.Tensor]]
    w_accs: List[float]
    event: Optional["torch.cuda.Event"] = None
    _stacked: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _rows: List[int] = dataclasses.field(default_factory=list, repr=False)

    def block_until_ready(self) -> "PendingTimelines":
        if self.event is not None:
            self.event.synchronize()
        return self

    def result(self) -> List[TimelineResult]:
        """The one device-to-host copy, into :class:`TimelineResult`s."""
        host = {k: v.cpu().numpy() for k, v in self._stacked.items()}
        return [TimelineResult(
            ipc_acc=host["ipc_acc"][k],
            w_acc=w_acc,
            cache_units=host["cache_units"][k].astype(np.int64),
            bandwidth=host["bandwidth"][k],
            prefetch_on=host["prefetch_on"][k],
            active=host["active"][k])
            for k, w_acc in zip(self._rows, self.w_accs)]


def run_timelines(
    params: Dict[str, torch.Tensor],
    specs: Sequence[TimelineSpec],
    **kwargs,
) -> List[TimelineResult]:
    """:func:`run_timelines_async` followed by its one host copy: one
    :class:`TimelineResult` of host arrays per spec."""
    return run_timelines_async(params, specs, **kwargs).result()


def run_timelines_async(
    params: Dict[str, torch.Tensor],
    specs: Sequence[TimelineSpec],
    *,
    total_units: int,
    total_bandwidth: float,
    llc_extra_cycles: float = 0.0,
    min_ways=4,
    speedup_threshold=1.05,
    min_bandwidth_allocation=1.0,
    atd_decay=0.5,
    bandwidth_delay_decay=0.5,
    iters: int = FIXED_POINT_ITERS,
) -> PendingTimelines:
    """Run a whole manager set's timelines on the parameters' device.

    Args:
      params: mix-stacked model parameters, every field an ``(M, n)``
        float64 tensor (:func:`repro_torch.sim.apps.from_numpy`).
      specs: one :class:`TimelineSpec` per manager.
      min_ways / speedup_threshold / min_bandwidth_allocation / atd_decay /
        bandwidth_delay_decay: scalars or per-mix arrays (trailing
        singleton axes allowed), shared by every manager.

    The managers run in buckets of equal table length
    (:func:`_length_buckets`), each over its own slot count, so a
    short-table manager (a fully static one has one slot) is not evaluated
    on every slot of the longest table.  The buckets share the slot loop:
    a slot evaluates the rows of the buckets still running, and the greedy
    launches once per slot on every bucket's reallocating rows.

    Returns:
      A :class:`PendingTimelines` whose tensors stay on the device; its
      ``result()`` brings them to the host once.
    """
    if not specs:
        raise ValueError("need at least one TimelineSpec")
    shape = tuple(params["cpi_base"].shape)
    if len(shape) != 2:
        raise ValueError(f"params must be mix-stacked (M, n); got {shape}")
    M, n = shape

    # Feasibility checks, once on the host before the run.
    if any(s.bandwidth_dynamic for s in specs):
        check_bandwidth_floor(min_bandwidth_allocation, n, total_bandwidth)
    if any(s.cache_dynamic for s in specs) and np.any(
            np.asarray(min_ways, dtype=np.int64) * n > int(total_units)):
        raise ValueError("min_ways * n exceeds capacity")

    tables = [segment_table(s.schedule) for s in specs]
    accum = [RUN if s.variant == "cppf" else None for s in specs]
    K = len(specs)
    buckets = _length_buckets([len(t[0]) for t in tables])
    # Each bucket stacks its own tables; the buckets' rows follow each
    # other in ascending table length, padded with NOOP slots to the
    # longest.  A bucket's rows past its own slot count are frozen, so the
    # rows a slot evaluates are a suffix: from live_from[s] on.
    parts = [stack_tables([tables[i] for i in b], [accum[i] for i in b])
             for b in buckets]
    S = max(part[0].shape[1] for part in parts)
    kinds, acc, reconf = (np.concatenate([np.pad(
        part[j], ((0, 0), (0, S - part[j].shape[1])), constant_values=fill)
        for part in parts]) for j, fill in ((0, NOOP), (1, 0.0), (2, False)))
    live_from = np.zeros(S, dtype=np.int64)
    for b, part in zip(buckets, parts):
        live_from[part[0].shape[1]:] += len(b) * M
    order = [i for b in buckets for i in b]
    specs = [specs[i] for i in order]
    accum = [accum[i] for i in order]
    tables = [tables[i] for i in order]

    B = K * M
    dev = params["cpi_base"].device
    U = int(total_units)

    cache_dyn_k = np.array([s.cache_dynamic for s in specs])
    cache_pol_k = np.array([s.cache_policy for s in specs])
    any_cache_dynamic = bool(cache_dyn_k.any())
    any_bandwidth_dynamic = any(s.bandwidth_dynamic for s in specs)
    any_policy = any(s.cache_policy or s.bw_policy for s in specs)
    has_sampling = bool(np.isin(kinds, (SAMPLE_OFF, SAMPLE_ON)).any())
    max_banks = max(s.bandwidth_banks for s in specs)

    def rows(per_manager, dtype) -> torch.Tensor:
        """A (K,) per-manager value as a (B, 1) per-row tensor."""
        return torch.as_tensor(
            np.repeat(np.asarray(per_manager), M)[:, None], dtype=dtype,
            device=dev)

    def tunable(value, dtype=np.float64) -> torch.Tensor:
        """A scalar or per-mix tunable as a (B, 1) per-row tensor."""
        return torch.as_tensor(np.tile(_per_mix(value, M, dtype), (K, 1)),
                               device=dev)

    def stacked(field, dtype) -> torch.Tensor:
        return torch.as_tensor(np.concatenate([
            np.broadcast_to(np.asarray(getattr(s, field)), (M, n))
            for s in specs]), dtype=dtype, device=dev)

    # ---- upload: per-row parameters, tunables, flags and the table ---- #
    p = {k: v.repeat(K, 1) for k, v in params.items()}          # (B, n)
    min_ways_r = tunable(min_ways, np.int32)[:, 0]              # (B,)
    thr = tunable(speedup_threshold)
    min_bw = tunable(min_bandwidth_allocation)
    atd_decay_r = tunable(atd_decay)
    bw_decay = tunable(bandwidth_delay_decay)
    bw_dyn = rows([s.bandwidth_dynamic for s in specs], torch.bool)
    cache_part = rows([s.cache_partitioned for s in specs], torch.bool)
    bw_part = rows([s.bandwidth_partitioned for s in specs], torch.bool)
    is_cppf = rows([s.variant == "cppf" for s in specs], torch.bool)
    banks_row = (rows([float(s.bandwidth_banks) for s in specs], F64)
                 if max_banks > 1 else None)
    kinds_r = torch.as_tensor(np.repeat(kinds, M, axis=0), device=dev)
    acc_r = torch.as_tensor(np.repeat(acc, M, axis=0), dtype=F64,
                            device=dev)
    reconf_r = torch.as_tensor(np.repeat(reconf, M, axis=0), device=dev)
    if any_policy:
        qos_bound = rows([s.qos_bound for s in specs], F64)
        qos_gain = rows([s.qos_gain for s in specs], F64)

    units = stacked("init_units", torch.int32)
    bw = stacked("init_bandwidth", F64)
    pf = stacked("init_prefetch", torch.bool)
    active = torch.ones((B, n), dtype=torch.bool, device=dev)
    zeros = torch.zeros((B, n), dtype=F64, device=dev)
    w_off = w_on = bw_acc = ipc_acc = off_ipc = ref_ipc = prev_ipc = zeros

    if any_cache_dynamic:
        # The ATD is linear in the per-step hit curves, and those take two
        # values per client (prefetch off / on), so the run carries two
        # (B, n) weight accumulators and materializes the (G*M, n, U+1)
        # ATD grid only at a boundary, for the blocks that reallocate.
        hits_off = memsys.hit_curves(p, zeros, U)
        hits_on = memsys.hit_curves(p, torch.ones_like(zeros), U)

    def atd(sl: slice) -> torch.Tensor:
        return (hits_off[sl] * w_off[sl][..., :, None]
                + hits_on[sl] * w_on[sl][..., :, None])

    total_cache_f = float(U)
    total_bw = float(total_bandwidth)
    llc_extra = float(llc_extra_cycles)

    for s in range(kinds.shape[1]):
        kind = kinds_r[:, s:s + 1]                                 # (B, 1)
        acc_dt = acc_r[:, s:s + 1]
        if reconf[:, s].any():
            # ---- boundary: bandwidth, then cache (paper priority) ---- #
            do_r = reconf_r[:, s:s + 1]
            if any_bandwidth_dynamic:
                bw = torch.where(do_r & bw_dyn,
                                 allocate_bandwidth(bw_acc, total_bw,
                                                    min_bw),
                                 bw)
            realloc = np.flatnonzero(reconf[:, s] & cache_dyn_k)
            blocks = [slice(k * M, (k + 1) * M) for k in realloc]
            look = [sl for k, sl in zip(realloc, blocks)
                    if cache_pol_k[k] == policies.CACHE_LOOKAHEAD]
            if look:
                fresh = lookahead_masked_traced(
                    torch.cat([atd(sl) for sl in look]),
                    torch.cat([min_ways_r[sl] for sl in look]),
                    torch.cat([active[sl] for sl in look]), U)
                for g, sl in enumerate(look):
                    units[sl] = fresh[g * M:(g + 1) * M]
            for k, sl in zip(realloc, blocks):
                if cache_pol_k[k] == policies.CACHE_AUCTION:
                    units[sl], bw[sl] = policies.auction_allocate(
                        atd(sl), bw_acc[sl], min_ways=min_ways_r[sl, None],
                        total_units=U, min_bandwidth=min_bw[sl],
                        total_bandwidth=total_bw)
                elif cache_pol_k[k] == policies.CACHE_QOS:
                    slow = torch.where(
                        prev_ipc[sl] > 0,
                        ref_ipc[sl] / torch.where(prev_ipc[sl] > 0,
                                                  prev_ipc[sl], 1.0),
                        1.0)
                    units[sl], bw[sl] = policies.qos_allocate(
                        atd(sl), bw_acc[sl], slow,
                        min_ways=min_ways_r[sl, None], total_units=U,
                        min_bandwidth=min_bw[sl], total_bandwidth=total_bw,
                        bound=qos_bound[sl], gain=qos_gain[sl])
            if any_cache_dynamic:
                w_off = torch.where(do_r, w_off * atd_decay_r, w_off)
                w_on = torch.where(do_r, w_on * atd_decay_r, w_on)

        # ---- one interval of the model ------------------------------ #
        # The A/B samples force the prefetcher off/on for everyone.
        pf_f = pf.to(F64)
        if has_sampling:
            pf_f = torch.where(kind == SAMPLE_OFF, 0.0,
                               torch.where(kind == SAMPLE_ON, 1.0, pf_f))
        # Frozen rows are skipped: they get IPC and delay 0, which their
        # zero weights and NOOP masks leave out of every accumulator.
        r0 = int(live_from[s])
        ipc, q_ns, *_ = memsys._evaluate_rowflags(
            {k: v[r0:] for k, v in p.items()}, units[r0:].to(F64), bw[r0:],
            pf_f[r0:], total_cache_f, total_bw, llc_extra, cache_part[r0:],
            bw_part[r0:], iters=iters,
            bandwidth_banks=None if banks_row is None else banks_row[r0:],
            max_banks=max_banks)
        if r0:
            ipc = torch.cat([ipc.new_zeros((r0, n)), ipc])
            q_ns = torch.cat([q_ns.new_zeros((r0, n)), q_ns])
        if any_policy:
            # QoS slowdown signal: reference = each row's first executed
            # segment, denominator = its latest one.
            executed = kind != NOOP
            ref_ipc = torch.where((ref_ipc == 0.0) & executed, ipc, ref_ipc)
            prev_ipc = torch.where(executed, ipc, prev_ipc)

        # ---- controller state --------------------------------------- #
        # Weights come from the table: CPpf's probes and NOOP slots carry
        # weight 0, a bitwise no-op on the accumulators.
        if any_cache_dynamic:
            kappa = (ipc * FREQ_GHZ * 1e6 / 1000.0) * acc_dt
            on_mask = pf_f == 1.0
            w_on = w_on + torch.where(on_mask, kappa, 0.0)
            w_off = w_off + torch.where(on_mask, 0.0, kappa)
        ipc_acc = ipc_acc + ipc * acc_dt
        if any_bandwidth_dynamic:
            # The delay EMA advances once per executed segment only.
            executes = (kind != NOOP) & bw_dyn
            bw_acc = torch.where(executes, bw_decay * bw_acc + q_ns * acc_dt,
                                 bw_acc)
        if has_sampling:
            decision = throttle_decision(ipc, off_ipc, thr)
            sample_on = kind == SAMPLE_ON
            active = torch.where(sample_on & is_cppf, ~decision, active)
            pf = torch.where(sample_on & ~is_cppf, decision, pf)
            off_ipc = torch.where(kind == SAMPLE_OFF, ipc, off_ipc)

    stacked = {k: v.reshape(K, M, n) for k, v in
               {"ipc_acc": ipc_acc, "cache_units": units, "bandwidth": bw,
                "prefetch_on": pf, "active": active}.items()}
    # Spec i's rows sit at position order.index(i) of the bucketed stack.
    rows = [order.index(i) for i in range(K)]
    event = None
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return PendingTimelines(
        device_results=[{k: v[r] for k, v in stacked.items()}
                        for r in rows],
        w_accs=[_weight(tables[r], accum[r]) for r in rows],
        event=event, _stacked=stacked, _rows=rows)


def _weight(table, only: Optional[int]) -> float:
    """The accumulated weight (ms) of one manager's own table, so it does
    not depend on where stacking placed its rows."""
    kinds, durations, _reconf = table
    return float(np.where((kinds == only) if only is not None
                          else np.ones_like(kinds, dtype=bool),
                          durations, 0.0).sum())
