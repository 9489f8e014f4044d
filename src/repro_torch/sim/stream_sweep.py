"""Fault-tolerant streaming sweep service: 10^5-10^6 mixes, chunked, with
online aggregation and checkpoint/resume (counterpart of
:mod:`repro.sim.stream_sweep`).

The Table-3 manager set is evaluated over a stream of scenario chunks
(:func:`repro_torch.sim.workloads.scenario_chunk`).  Each chunk runs as
one stacked timeline (:func:`repro_torch.sim.timeline.run_timelines_async`,
which reaches the Lookahead greedy kernel at every CBP reallocation), one
shared equal-share baseline and one metrics step with its finite guard,
all on the chunk's device; the metrics come back to the host in one
copy and fold into :class:`StreamAggregates`.

Pipeline
    Every device operation of a chunk runs on the runner's own CUDA
    stream on the card: the upload of the chunk's parameters, the
    timelines, the baseline, the metrics and the fetch.  With
    ``overlap=True`` a worker thread does them while the main thread
    generates the next chunk and folds the previous one, in numpy only,
    touching no tensor; joins are FIFO, so folds happen in chunk order
    and an overlapped stream equals a serial one bit for bit.  The
    chunk's device work is host-bound dispatch, which both threads share
    under one interpreter lock, so the overlap gains nothing on the card
    and streams run serially by default.  The stream holds no device
    tensor of chunk c once chunk c's metrics are on the host, so its
    device memory is that of one chunk whatever the stream's length.

Online aggregates
    A running log-sum for the geomean weighted speedup, a fixed-bin
    histogram sketch for the slowdown percentiles, the running worst
    slowdown and lowest fairness: plain float64 numpy folded in chunk
    order, so a resumed run equals an uninterrupted one bit for bit.

Robustness (each layer fault-injectable through
:class:`repro_torch.runtime.faultinject.FaultPlan`): a failed dispatch is
retried with exponential backoff (:class:`RetryPolicy`), then
quarantined, and the report names every quarantined chunk and its
``coverage``; a non-finite result is caught by the finite guard
(:class:`NumericalDivergenceError`, quarantined by default); per-chunk
walls feed a :class:`repro_torch.runtime.fault.StragglerWatchdog`; the
service state checkpoints atomically every ``checkpoint_every`` chunks
(:class:`repro_torch.checkpoint.CheckpointManager`, the reference's
layout) and a killed run resumes from the last complete checkpoint;
``max_consecutive_quarantines`` aborts a stream that is broken rather
than degraded.

The retry barrier catches ``Exception``, as the reference's does, so it
would also quarantine a real failure of the card or of the kernel: a
healthy run must report ``coverage == 1.0`` and no retries
(``tests/test_torch_stream_sweep.py``, ``chip_smoke.py`` phase 13).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import pathlib
import time
import types
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import CBPParams
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.runtime.fault import StragglerWatchdog
from repro_torch.runtime.faultinject import FaultPlan
from repro_torch.sim import memsys, policies, timeline
from repro_torch.sim.apps import from_numpy
from repro_torch.sim.managers import MANAGER_NAMES
from repro_torch.sim.runner import equal_share
from repro_torch.sim.workloads import StreamScenario, scenario_chunk


class NumericalDivergenceError(RuntimeError):
    """A (manager, mix) row produced a non-finite result; names the
    manager and the *global* mix index."""

    def __init__(self, manager: str, mix_index: int, chunk_index: int):
        self.manager = manager
        self.mix_index = mix_index
        self.chunk_index = chunk_index
        super().__init__(
            f"non-finite result for manager {manager!r}, mix {mix_index} "
            f"(chunk {chunk_index})")


class CheckpointMismatchError(RuntimeError):
    """A resume was attempted against a checkpoint of a different stream
    (different seed/shape/scenario): resuming would corrupt aggregates."""


class StreamAbortedError(RuntimeError):
    """Too many consecutive chunk quarantines: the stream is broken, not
    degraded."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for chunk dispatch failures."""

    max_retries: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * self.multiplier ** attempt,
                   self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Shape + policy of one streaming sweep run."""

    n_mixes: int
    chunk_size: int = 512
    managers: Optional[Tuple[str, ...]] = None   # None = all MANAGER_NAMES
    total_ms: float = 50.0
    seed: int = 0
    scenario: StreamScenario = dataclasses.field(
        default_factory=StreamScenario)
    total_cache_units: int = 256
    total_bandwidth: float = 64.0
    llc_extra_cycles: float = 0.0
    params: CBPParams = dataclasses.field(default_factory=CBPParams)
    # Aggregation sketch: fixed uniform bins over [0, hist_max_slowdown)
    # plus a final overflow bin.
    hist_bins: int = 512
    hist_max_slowdown: float = 8.0
    # Robustness policy.
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    on_divergence: str = "quarantine"            # "quarantine" | "raise"
    max_consecutive_quarantines: int = 8
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8
    watchdog_threshold: float = 3.0
    watchdog_warmup: int = 3

    def __post_init__(self):
        if self.n_mixes < 1 or self.chunk_size < 1:
            raise ValueError("n_mixes and chunk_size must be >= 1")
        if self.on_divergence not in ("quarantine", "raise"):
            raise ValueError(
                f"unknown on_divergence {self.on_divergence!r}")
        if self.hist_bins < 2:
            raise ValueError("hist_bins must be >= 2")
        # UnknownManagerError (a ValueError) on the first unregistered name.
        policies.validate_manager_names(self.manager_names)

    @property
    def manager_names(self) -> List[str]:
        return (list(MANAGER_NAMES) if self.managers is None
                else list(self.managers))

    @property
    def n_chunks(self) -> int:
        return -(-self.n_mixes // self.chunk_size)

    def fingerprint(self) -> str:
        """Stream identity (the reference's string for the same
        configuration): a resumed run must match it exactly."""
        payload = {
            "n_mixes": self.n_mixes, "chunk_size": self.chunk_size,
            "managers": self.manager_names, "total_ms": self.total_ms,
            "seed": self.seed,
            "scenario": dataclasses.asdict(self.scenario),
            "caps": [self.total_cache_units, self.total_bandwidth,
                     self.llc_extra_cycles],
            "params": dataclasses.asdict(self.params),
            "hist": [self.hist_bins, self.hist_max_slowdown],
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


class StreamAggregates:
    """Online per-manager aggregates: the whole memory of a 10^6-mix
    stream is these few (K,)- and (K, bins)-shaped arrays, folded in plain
    float64 numpy in chunk order."""

    def __init__(self, n_managers: int, hist_bins: int,
                 hist_max_slowdown: float):
        self.hist_bins = int(hist_bins)
        self.hist_max = float(hist_max_slowdown)
        # Uniform bins over [0, hist_max) with bin (hist_bins - 1) as the
        # overflow bucket; width excludes the overflow bin.
        self.bin_width = self.hist_max / (self.hist_bins - 1)
        k = int(n_managers)
        self.mix_count = np.zeros(k, dtype=np.int64)
        self.log_ws_sum = np.zeros(k, dtype=np.float64)
        self.slowdown_hist = np.zeros((k, self.hist_bins), dtype=np.int64)
        self.max_slowdown = np.zeros(k, dtype=np.float64)
        self.min_fairness = np.full(k, np.inf, dtype=np.float64)

    def fold(self, ws: np.ndarray, slowdown: np.ndarray,
             fairness: np.ndarray) -> None:
        """Fold one chunk: ws (K, M), slowdown (K, M, n), fairness (K, M)."""
        ws = np.asarray(ws, dtype=np.float64)
        slowdown = np.asarray(slowdown, dtype=np.float64)
        fairness = np.asarray(fairness, dtype=np.float64)
        k, m = ws.shape
        self.mix_count += m
        self.log_ws_sum += np.log(ws).sum(axis=1)
        bins = np.clip(
            (slowdown / self.bin_width).astype(np.int64),
            0, self.hist_bins - 1)
        for ki in range(k):
            self.slowdown_hist[ki] += np.bincount(
                bins[ki].ravel(), minlength=self.hist_bins)
        self.max_slowdown = np.maximum(
            self.max_slowdown, slowdown.max(axis=(1, 2)))
        self.min_fairness = np.minimum(
            self.min_fairness, fairness.min(axis=1))

    # -------------------------------------------------------- queries #

    def geomean_ws(self) -> np.ndarray:
        with np.errstate(invalid="ignore"):
            return np.exp(self.log_ws_sum / np.maximum(self.mix_count, 1))

    def slowdown_percentile(self, q: float) -> np.ndarray:
        """Histogram-sketch percentile per manager (q in (0, 1))."""
        out = np.zeros(len(self.mix_count), dtype=np.float64)
        for ki, hist in enumerate(self.slowdown_hist):
            total = hist.sum()
            if total == 0:
                out[ki] = np.nan
                continue
            target = q * total
            cum = np.cumsum(hist)
            b = int(np.searchsorted(cum, target))
            prev = cum[b - 1] if b > 0 else 0
            frac = ((target - prev) / hist[b]) if hist[b] else 0.0
            out[ki] = (b + frac) * self.bin_width
        return out

    # ---------------------------------------------- checkpoint tree #

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {
            "mix_count": self.mix_count,
            "log_ws_sum": self.log_ws_sum,
            "slowdown_hist": self.slowdown_hist,
            "max_slowdown": self.max_slowdown,
            "min_fairness": self.min_fairness,
        }

    def load_tree(self, tree: Dict[str, np.ndarray]) -> None:
        for key, value in self.to_tree().items():
            arr = np.asarray(tree[key], dtype=value.dtype)
            if arr.shape != value.shape:
                raise CheckpointMismatchError(
                    f"aggregate {key!r} shape {arr.shape} != "
                    f"expected {value.shape}")
            setattr(self, key, arr)


@dataclasses.dataclass
class StreamReport:
    """The deliverable of one stream run (resumed or not)."""

    manager_names: List[str]
    n_mixes: int
    mixes_covered: int
    coverage: float
    chunks: int
    quarantined: List[Tuple[int, str]]
    retries: int
    geomean_ws: Dict[str, float]
    p50_slowdown: Dict[str, float]
    p90_slowdown: Dict[str, float]
    p99_slowdown: Dict[str, float]
    max_slowdown: Dict[str, float]
    min_fairness: Dict[str, float]
    straggler_events: int
    straggler_mitigations: int
    wall_s: float
    resumed_from: Optional[int]
    aggregates: StreamAggregates

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.pop("aggregates")
        d["quarantined"] = [[int(c), r] for c, r in self.quarantined]
        return d


@dataclasses.dataclass
class _ChunkOutcome:
    """What the worker thread hands back for one chunk (host arrays)."""

    status: str                       # "ok" | "dispatch_failed"
    retries: int = 0
    error: Optional[str] = None
    ws: Optional[np.ndarray] = None          # (K, M_valid)
    slowdown: Optional[np.ndarray] = None    # (K, M_valid, n)
    fairness: Optional[np.ndarray] = None    # (K, M_valid)
    finite: Optional[np.ndarray] = None      # (K, M_valid) bool


def _spec_plant(m: int, n: int, total_units: int, total_bandwidth: float):
    """The duck-typed plant ``sweep._manager_spec`` needs: shape + caps."""
    return types.SimpleNamespace(
        n_mixes=m, n_clients=n, total_cache_units=total_units,
        total_bandwidth=total_bandwidth)


def _build_specs(cfg: StreamConfig, n: int):
    """One TimelineSpec per manager at the chunk shape, built once: every
    chunk shares the schedules and the step-0 state."""
    from repro_torch.sim.sweep import _manager_spec

    plant = _spec_plant(cfg.chunk_size, n, cfg.total_cache_units,
                        cfg.total_bandwidth)
    return [_manager_spec(plant, name, cfg.total_ms, cfg.params)
            for name in cfg.manager_names]


def _chunk_metrics(ipc_stack: torch.Tensor, w_accs: torch.Tensor,
                   base_ipc: torch.Tensor):
    """The metrics and the finite guard, on the chunk's device.

    ipc_stack (K, M, n) time-weighted IPC sums; w_accs (K, 1, 1);
    base_ipc (M, n).  Returns ws (K, M), slowdown (K, M, n), fairness
    (K, M) and the finite guard (K, M): ``isfinite`` over every row and
    ``ipc > 0``, before any transfer.
    """
    ipc = ipc_stack / w_accs
    speedup = ipc / base_ipc[None]
    ws = torch.mean(speedup, dim=-1)
    slowdown = base_ipc[None] / ipc
    fairness = speedup.amin(dim=-1) / speedup.amax(dim=-1)
    finite = (torch.isfinite(ipc).all(dim=-1)
              & torch.isfinite(base_ipc).all(dim=-1)[None]
              & (ipc > 0.0).all(dim=-1))
    return ws, slowdown, fairness, finite


class _StreamRunner:
    """One stream execution: pipeline, fault handling, checkpointing."""

    def __init__(self, cfg: StreamConfig, plan: Optional[FaultPlan],
                 overlap: bool, sleep_fn: Callable[[float], None],
                 device: torch.device):
        self.cfg = cfg
        self.plan = plan or FaultPlan()
        self.overlap = overlap
        self.sleep_fn = sleep_fn
        self.device = device
        self.names = cfg.manager_names
        self.K = len(self.names)
        self.n = cfg.scenario.apps_per_mix
        self.specs = _build_specs(cfg, self.n)
        self.agg = StreamAggregates(self.K, cfg.hist_bins,
                                    cfg.hist_max_slowdown)
        self.quarantined: List[Tuple[int, str]] = []
        self.retries = 0
        self.cursor = 0
        self.resumed_from: Optional[int] = None
        self.watchdog = StragglerWatchdog(
            threshold=cfg.watchdog_threshold,
            warmup=cfg.watchdog_warmup)
        self._consecutive_quarantines = 0
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        self.ckpt = None
        if cfg.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(
                pathlib.Path(cfg.checkpoint_dir), keep=3)

    # ----------------------------------------------------- checkpoint #

    def try_resume(self) -> None:
        if self.ckpt is None:
            return
        restored = self.ckpt.restore_latest(self.agg.to_tree())
        if restored is None:
            return
        step, tree, extra = restored
        if extra.get("fingerprint") != self.cfg.fingerprint():
            raise CheckpointMismatchError(
                f"checkpoint at {self.cfg.checkpoint_dir} belongs to a "
                f"different stream (fingerprint "
                f"{extra.get('fingerprint')!r} != "
                f"{self.cfg.fingerprint()!r})")
        self.agg.load_tree(tree)
        self.cursor = int(extra["cursor"])
        self.resumed_from = self.cursor
        self.quarantined = [(int(c), str(r))
                            for c, r in extra.get("quarantined", [])]
        self.retries = int(extra.get("retries", 0))

    def checkpoint(self, next_chunk: int) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(
            next_chunk, self.agg.to_tree(),
            extra={
                "fingerprint": self.cfg.fingerprint(),
                "cursor": next_chunk,
                "quarantined": [[int(c), r] for c, r in self.quarantined],
                "retries": self.retries,
                "seed": self.cfg.seed,
            })

    # ------------------------------------------------------- pipeline #

    def _valid_rows(self, chunk_idx: int) -> int:
        start = chunk_idx * self.cfg.chunk_size
        return min(self.cfg.chunk_size, self.cfg.n_mixes - start)

    def _generate(self, chunk_idx: int) -> Dict[str, np.ndarray]:
        params = scenario_chunk(self.cfg.scenario, self.cfg.seed,
                                chunk_idx, self.cfg.chunk_size)
        params.pop("mix_indices", None)
        return params

    @contextlib.contextmanager
    def on_device(self) -> Iterator[None]:
        """Make the runner's own CUDA stream current in this thread (after
        the work already queued on the device's default stream); a no-op
        on the CPU."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def dispatch(self, params: Dict[str, np.ndarray]):
        """One chunk's device work up to its metrics: the upload of the
        parameters, the stacked timelines and the shared baseline.
        Returns ``(PendingTimelines, (M, n) baseline IPC tensor)``."""
        cfg = self.cfg
        p = from_numpy(params, self.device)
        pending = timeline.run_timelines_async(
            p, self.specs,
            total_units=cfg.total_cache_units,
            total_bandwidth=cfg.total_bandwidth,
            llc_extra_cycles=cfg.llc_extra_cycles,
            min_ways=cfg.params.min_ways,
            speedup_threshold=cfg.params.speedup_threshold,
            min_bandwidth_allocation=cfg.params.min_bandwidth_allocation,
            atd_decay=cfg.params.atd_decay,
            bandwidth_delay_decay=cfg.params.bandwidth_delay_decay)
        return pending, self._baseline(p)

    def _dispatch_and_fetch(self, chunk_idx: int,
                            params: Dict[str, np.ndarray]) -> _ChunkOutcome:
        """The worker-thread body: the retrying dispatch, then the metrics
        and their one copy to the host."""
        cfg = self.cfg
        with self.on_device():
            attempt = 0
            while True:
                try:
                    self.plan.on_dispatch(chunk_idx, attempt)
                    pending, base = self.dispatch(params)
                    break
                except Exception as exc:  # noqa: BLE001 — quarantine barrier
                    if attempt >= cfg.retry.max_retries:
                        return _ChunkOutcome(
                            status="dispatch_failed", retries=attempt,
                            error=f"{type(exc).__name__}: {exc}")
                    self.sleep_fn(cfg.retry.delay(attempt))
                    attempt += 1
                    self.retries += 1

            ipc_stack = torch.stack(
                [d["ipc_acc"] for d in pending.device_results])
            if self.plan.poisons(chunk_idx):
                # Poison the device-resident results so the injected
                # divergence meets the same finite guard a genuine solver
                # blow-up would.
                ipc_stack = torch.full_like(ipc_stack, float("nan"))
            w_accs = torch.as_tensor(pending.w_accs, dtype=F64,
                                     device=self.device)[:, None, None]
            ws, slowdown, fairness, finite = _chunk_metrics(
                ipc_stack, w_accs, base)
            valid = self._valid_rows(chunk_idx)
            host = torch.cat(
                [slowdown, ws[..., None], fairness[..., None],
                 finite[..., None].to(F64)], dim=-1)[:, :valid].cpu().numpy()
        n = self.n
        return _ChunkOutcome(
            status="ok", retries=attempt,
            ws=host[..., n], slowdown=host[..., :n],
            fairness=host[..., n + 1], finite=host[..., n + 2] != 0.0)

    def _baseline(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Shared unpartitioned baseline IPC of this chunk (on the device)."""
        cfg = self.cfg
        m = cfg.chunk_size
        units, bw = equal_share(self.n, cfg.total_cache_units,
                                cfg.total_bandwidth)
        ss = memsys.evaluate(
            params,
            np.tile(units.astype(np.float64), (m, 1)),
            np.tile(bw, (m, 1)),
            np.zeros((m, self.n), dtype=bool),
            cache_partitioned=False,
            bandwidth_partitioned=False,
            total_cache_units=float(cfg.total_cache_units),
            total_bandwidth_gbps=cfg.total_bandwidth,
            llc_extra_cycles=cfg.llc_extra_cycles,
        )
        return ss.ipc

    def _quarantine(self, chunk_idx: int, reason: str) -> None:
        self.quarantined.append((chunk_idx, reason))
        self._consecutive_quarantines += 1
        if (self._consecutive_quarantines
                > self.cfg.max_consecutive_quarantines):
            raise StreamAbortedError(
                f"{self._consecutive_quarantines} consecutive chunks "
                f"quarantined (last: chunk {chunk_idx}: {reason}); the "
                f"stream is broken, not degraded — aborting instead of "
                f"reporting near-zero coverage")

    def _finish(self, chunk_idx: int, outcome: _ChunkOutcome,
                wall_s: float) -> None:
        """Fold/quarantine one fetched chunk (host thread, in order)."""
        wall_s += self.plan.straggle_seconds(chunk_idx)
        # Mitigation on a single host is log-only; counts go in the report.
        self.watchdog.observe(chunk_idx, wall_s)
        if outcome.status != "ok":
            self._quarantine(
                chunk_idx, f"dispatch_failed after "
                f"{outcome.retries} retries ({outcome.error})")
            return
        if not outcome.finite.all():
            k, m = np.argwhere(~outcome.finite)[0]
            err = NumericalDivergenceError(
                self.names[int(k)],
                chunk_idx * self.cfg.chunk_size + int(m),
                chunk_idx)
            if self.cfg.on_divergence == "raise":
                raise err
            self._quarantine(chunk_idx, str(err))
            return
        self._consecutive_quarantines = 0
        self.agg.fold(outcome.ws, outcome.slowdown, outcome.fairness)

    def run(self) -> StreamReport:
        cfg = self.cfg
        t_start = time.monotonic()
        n_chunks = cfg.n_chunks
        pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                if self.overlap else None)
        # Depth-2 pipeline: chunk c is submitted to the worker before
        # chunk c-1 is joined, so the fold/checkpoint of c-1 and the
        # generation of c+1 run on the main thread while the worker is
        # inside chunk c.  Joins are FIFO: folds happen in chunk order.
        queue: List[Tuple[int, object, float]] = []
        try:
            for c in range(self.cursor, n_chunks):
                self.plan.on_chunk_start(c)
                params = self._generate(c)
                if self.overlap:
                    t0 = time.monotonic()
                    fut = pool.submit(self._dispatch_and_fetch, c, params)
                    queue.append((c, fut, t0))
                    if len(queue) > 1:
                        self._join(queue.pop(0))
                else:
                    t0 = time.monotonic()
                    outcome = self._dispatch_and_fetch(c, params)
                    self._finish(c, outcome, time.monotonic() - t0)
                    self._maybe_checkpoint(c)
            while queue:
                self._join(queue.pop(0))
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        return self._report(time.monotonic() - t_start)

    def _join(self, pending: Tuple[int, object, float]) -> None:
        c, fut, t0 = pending
        outcome = fut.result()
        self._finish(c, outcome, time.monotonic() - t0)
        self._maybe_checkpoint(c)

    def _maybe_checkpoint(self, chunk_idx: int) -> None:
        done = chunk_idx + 1
        if self.ckpt is not None and (done % self.cfg.checkpoint_every == 0
                                      or done == self.cfg.n_chunks):
            self.checkpoint(done)

    def _report(self, wall_s: float) -> StreamReport:
        cfg = self.cfg
        quarantined_mixes = sum(self._valid_rows(c)
                                for c, _ in self.quarantined)
        covered = cfg.n_mixes - quarantined_mixes
        per = {}
        for label, arr in (
                ("geomean_ws", self.agg.geomean_ws()),
                ("p50", self.agg.slowdown_percentile(0.50)),
                ("p90", self.agg.slowdown_percentile(0.90)),
                ("p99", self.agg.slowdown_percentile(0.99)),
                ("max_slowdown", self.agg.max_slowdown),
                ("min_fairness", self.agg.min_fairness)):
            per[label] = {name: round(float(v), 6)
                          for name, v in zip(self.names, arr)}
        return StreamReport(
            manager_names=list(self.names),
            n_mixes=cfg.n_mixes,
            mixes_covered=covered,
            coverage=covered / cfg.n_mixes,
            chunks=cfg.n_chunks,
            quarantined=list(self.quarantined),
            retries=self.retries,
            geomean_ws=per["geomean_ws"],
            p50_slowdown=per["p50"],
            p90_slowdown=per["p90"],
            p99_slowdown=per["p99"],
            max_slowdown=per["max_slowdown"],
            min_fairness=per["min_fairness"],
            straggler_events=len(self.watchdog.events),
            straggler_mitigations=self.watchdog.mitigations,
            wall_s=wall_s,
            resumed_from=self.resumed_from,
            aggregates=self.agg,
        )


def run_stream(
    cfg: StreamConfig,
    *,
    fault_plan: Optional[FaultPlan] = None,
    resume: bool = False,
    overlap: bool = False,
    sleep_fn: Callable[[float], None] = time.sleep,
    device: DeviceLike = None,
) -> StreamReport:
    """Run (or resume) a streaming sweep.

    Args:
      cfg: stream shape + robustness policy.
      fault_plan: injected faults (tests/smokes); ``None`` = healthy run.
      resume: restore aggregates/cursor/quarantine from
        ``cfg.checkpoint_dir``'s latest complete checkpoint; a fresh run
        otherwise (an existing mismatched checkpoint raises
        :class:`CheckpointMismatchError`).
      overlap: generate chunk c+1 on the host while a worker thread runs
        chunk c; ``False`` (the default) = serial chunks.  Both give the
        same aggregates bit for bit; on an H100 the overlapped full head
        was slower in 9 of 10 alternating pairs (median ratio 1.07,
        ``tools/stream_pairs.py``), so serial is the default.
      sleep_fn: injected for backoff in tests (defaults to real sleep).
      device: ``None`` runs on the CUDA card and raises without one;
        ``"cpu"`` runs the same code on the CPU.

    Returns a :class:`StreamReport`; ``report.aggregates`` carries the raw
    sketches for bit-exact comparison.
    """
    runner = _StreamRunner(cfg, fault_plan, overlap, sleep_fn,
                           resolve_device(device))
    if resume:
        runner.try_resume()
    return runner.run()


__all__ = [
    "CheckpointMismatchError", "NumericalDivergenceError", "RetryPolicy",
    "StreamAbortedError", "StreamAggregates", "StreamConfig",
    "StreamReport", "run_stream",
]
