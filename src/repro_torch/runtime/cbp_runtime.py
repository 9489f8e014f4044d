"""CBP's runtime bindings (counterpart of :mod:`repro.runtime.cbp_runtime`):
the kernel-level binding, UCP Lookahead partitioning of an on-chip memory
budget among a kernel's tiles, and the training-loop binding's plant
(:class:`TrainingPlant`).

:func:`plan_matmul_blocks` runs the Lookahead allocator over
*tile-utility curves* (the device-memory traffic avoided as a function of
the budget given to the A tile, the B tile and the accumulator) and snaps
the allocation to ``(block_m, block_n, block_k)``: cache partitioning at
the level of a kernel's tiles.  :func:`plan_kernel_blocks` maps the four
kernels of :mod:`repro_torch.kernels` onto that query and plans a fleet
of them in one batched call (one greedy launch per capacity group).

The host arithmetic is the reference planner's, copied exactly, so the
same inputs give the same knobs; ``device`` (``None``: the card) takes the
place of the reference's ``allocator_backend``.  The default budget is the
reference planner's default, so that plans equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache_controller import (
    lookahead_allocate,
    lookahead_allocate_grouped,
)
from repro_torch.core.types import Allocation, IntervalStats
from repro_torch.device import DeviceLike, as_f64, resolve_device

#: The reference planner's default budget (16 MiB).
DEFAULT_BUDGET_BYTES = 16 * 1024 * 1024


def _tile_utility_curves(m: int, n: int, k: int, dtype_bytes: int,
                         unit_bytes: int, total_units: int) -> np.ndarray:
    """Utility of giving budget units to (A-tile, B-tile, ACC) for a
    (m x k) @ (k x n) matmul: utility = device-memory traffic avoided.

    Bigger block_m (A rows resident) divides B-panel re-reads; bigger
    block_n divides A re-reads; bigger block_k amortizes accumulator
    spills.  Concave in each — exactly the miss-curve shape UCP expects.
    """
    units = np.arange(total_units + 1, dtype=np.float64)
    vm = units * unit_bytes
    bm = np.maximum(vm / (2 * 128 * dtype_bytes), 8)
    util_a = n * k * dtype_bytes * (m / 8.0 - m / bm)
    bn = np.maximum(vm / (2 * 128 * dtype_bytes), 8)
    util_b = m * k * dtype_bytes * (n / 8.0 - n / bn)
    bk = np.maximum(vm / ((128 + 128) * dtype_bytes), 8)
    util_acc = m * n * 4.0 * (k / 8.0 - k / bk)
    return np.stack([util_a, util_b, util_acc])


_PLAN_UNIT = 8192                                 # 8 KiB budget "ways"
_PLAN_MIN_UNITS = 2


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _snap_block(raw: float, dim: int, *, align: int = 8,
                mxu: Optional[int] = 128) -> int:
    """Snap a budget-derived tile size to the largest feasible aligned block.

    Pad-aware: a block is *feasible* when it either divides ``dim`` exactly
    or is a multiple of ``align`` tiling the padded extent
    ``ceil(dim / block) * block``.  Among feasible candidates the one with
    the smallest padded extent wins, the larger block on ties, so exact
    aligned divisors beat padding and prime/odd dims keep a full-width
    aligned block.  ``mxu`` lifts a block to that multiple where the dim
    allows (the reference's matrix-unit alignment, kept for parity).
    """
    if dim <= align:
        return dim                    # whole extent: one padded tile
    ext = _round_up(dim, align)
    p = 2 ** int(np.floor(np.log2(max(raw, 1))))
    b = int(min(max(p, align), ext))
    if mxu is not None and ext >= mxu and b >= mxu // 2:
        b = max(b, mxu)
    if dim % b == 0:
        return b
    cands = [b] + [d for d in range(align, b + 1, align) if dim % d == 0]
    return min(cands, key=lambda c: (_round_up(dim, c), -c))


def _plan_from_alloc(m: int, n: int, k: int, alloc: np.ndarray,
                     dtype_bytes: int) -> Tuple[int, int, int]:
    """Shared alloc -> (block_m, block_n, block_k) snap, so the scalar and
    batched planners cannot disagree given identical allocations."""
    block_m = _snap_block(alloc[0] * _PLAN_UNIT / (2 * 128 * dtype_bytes), m)
    block_n = _snap_block(alloc[1] * _PLAN_UNIT / (2 * 128 * dtype_bytes), n)
    block_k = _snap_block(alloc[2] * _PLAN_UNIT / (256 * dtype_bytes), k,
                          mxu=None)
    return max(block_m, 1), max(block_n, 1), max(block_k, 1)


def _total_units(budget_bytes: int) -> int:
    return max(budget_bytes // _PLAN_UNIT, 6)


def plan_matmul_blocks(m: int, n: int, k: int, *, dtype_bytes: int = 2,
                       budget_bytes: int = DEFAULT_BUDGET_BYTES,
                       device: DeviceLike = None) -> Tuple[int, int, int]:
    """UCP-allocate ``budget_bytes`` among the A/B/ACC tiles -> blocks.

    The greedy runs on ``device`` (``None``: the card).  Blocks are
    pad-aware (:func:`_snap_block`): for dims with no aligned divisor the
    block tiles ``ceil(dim / block) * block``, and the matmul kernel masks
    the ragged edge.
    """
    total_units = _total_units(budget_bytes)
    curves = _tile_utility_curves(m, n, k, dtype_bytes, _PLAN_UNIT,
                                  total_units)
    alloc = lookahead_allocate(curves, total_units,
                               min_units=_PLAN_MIN_UNITS, device=device)
    return _plan_from_alloc(m, n, k, alloc, dtype_bytes)


def plan_matmul_blocks_batched(
    shapes: List[Tuple[int, int, int]], *,
    dtype_bytes=2,
    budget_bytes=DEFAULT_BUDGET_BYTES,
    device: DeviceLike = None,
) -> List[Tuple[int, int, int]]:
    """Plan many ``(m, n, k)`` shapes in one batched call.

    ``dtype_bytes`` / ``budget_bytes`` may be scalars or per-shape
    sequences.  Shapes are grouped by capacity (the budget fixes the
    utility-curve width) and each group is one greedy over all its shapes
    (:func:`repro_torch.core.cache_controller.lookahead_allocate_grouped`:
    one kernel launch per group on the card).  Per shape, the blocks equal
    :func:`plan_matmul_blocks`.
    """
    B = len(shapes)
    if B == 0:
        return []
    dbs = [int(d) for d in np.broadcast_to(dtype_bytes, (B,))]
    budgets = [int(v) for v in np.broadcast_to(budget_bytes, (B,))]
    total_units = [_total_units(vb) for vb in budgets]
    groups: Dict[int, List[int]] = {}
    for i, units in enumerate(total_units):
        groups.setdefault(units, []).append(i)
    keys = sorted(groups)
    curve_groups = [np.stack([
        _tile_utility_curves(*shapes[i], dbs[i], _PLAN_UNIT, units)
        for i in groups[units]]) for units in keys]
    allocs = lookahead_allocate_grouped(
        curve_groups, keys, min_units=_PLAN_MIN_UNITS, device=device)
    out: List[Optional[Tuple[int, int, int]]] = [None] * B
    for units, alloc in zip(keys, allocs):
        for j, i in enumerate(groups[units]):
            out[i] = _plan_from_alloc(*shapes[i], alloc[j], dbs[i])
    return out  # type: ignore[return-value]


# Per-kernel mapping of shape dims onto the (m, n, k) tile-utility query
# and of the planned (block_m, block_n, block_k) back onto the kernel's
# block knobs.  flash_decode queries with an 8-row Q tile (one padded
# tile of queries streams the whole KV); ssd_scan's chunk is both sides
# of the (chunk x chunk) intra-chunk decay matmul.
_KERNEL_PLAN_QUERIES: Dict[str, Callable] = {
    "cbp_matmul": lambda d: (d["m"], d["n"], d["k"]),
    "flash_attention": lambda d: (d["seq_q"], d["seq_kv"], d["head_dim"]),
    "flash_decode": lambda d: (8, d["seq_kv"], d["head_dim"]),
    "ssd_scan": lambda d: (d["seq_len"], d["seq_len"], d["state_dim"]),
}
_KERNEL_PLAN_KNOBS: Dict[str, Callable] = {
    "cbp_matmul": lambda bm, bn, bk: {
        "block_m": bm, "block_n": bn, "block_k": bk},
    "flash_attention": lambda bm, bn, bk: {"block_q": bm, "block_kv": bn},
    "flash_decode": lambda bm, bn, bk: {"block_kv": bn},
    "ssd_scan": lambda bm, bn, bk: {"chunk": min(bm, bn)},
}


def plan_kernel_blocks(specs: List[Dict], *,
                       device: DeviceLike = None) -> List[Dict]:
    """Plan block knobs for a fleet of the port's kernels in one call.

    Each spec is ``{"kernel": <name>, "dtype_bytes": ..,
    "budget_bytes": .., <dims>}`` where ``<dims>`` are the kernel's shape
    fields: ``cbp_matmul`` takes ``m/n/k``, ``flash_attention``
    ``seq_q/seq_kv/head_dim``, ``flash_decode`` ``seq_kv/head_dim``,
    ``ssd_scan`` ``seq_len/state_dim``.  Returns one knob dict per spec,
    planned by one :func:`plan_matmul_blocks_batched` call.
    """
    shapes, dbs, budgets = [], [], []
    for spec in specs:
        kern = spec["kernel"]
        if kern not in _KERNEL_PLAN_QUERIES:
            raise ValueError(f"unknown kernel {kern!r}; have "
                             f"{sorted(_KERNEL_PLAN_QUERIES)}")
        shapes.append(_KERNEL_PLAN_QUERIES[kern](spec))
        dbs.append(int(spec.get("dtype_bytes", 2)))
        budgets.append(int(spec.get("budget_bytes", DEFAULT_BUDGET_BYTES)))
    blocks = plan_matmul_blocks_batched(
        shapes, dtype_bytes=dbs, budget_bytes=budgets, device=device)
    return [_KERNEL_PLAN_KNOBS[spec["kernel"]](*blk)
            for spec, blk in zip(specs, blocks)]


# ------------------------------------------------------------------ #
# Training-loop binding
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class StreamKnobs:
    """What the plant applies to each client before an interval: ``(n,)``
    tensors on the plant's device."""

    buffer_units: torch.Tensor      # cache partition (staging pages)
    bandwidth_mbps: torch.Tensor    # host-side bandwidth shares
    prefetch_on: torch.Tensor


class TrainingPlant:
    """Adapts a training loop's ``step_fn`` to the CBP
    :class:`~repro_torch.core.coordinator.Plant` protocol.

    ``step_fn(interval_ms, knobs)`` runs the training loop for the
    interval under the given :class:`StreamKnobs` and returns per-client
    (throughput, queue_wait_ms, buffer_utility_curves).  The coordinator's
    state lives on ``device`` (``None``: the card); ``allocator_backend``
    is ``"device"`` (the Lookahead greedy kernel on the card, its plain
    version on the CPU) or ``"numpy"`` (the host golden).
    """

    def __init__(self, n_clients: int, total_buffer_units: int,
                 total_bandwidth_mbps: float,
                 step_fn: Callable[[float, StreamKnobs],
                                   Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
                 allocator_backend: str = "device",
                 device: DeviceLike = None):
        self.n_clients = n_clients
        self.total_cache_units = total_buffer_units
        self.total_bandwidth = total_bandwidth_mbps
        self.allocator_backend = allocator_backend
        self.device = resolve_device(device)
        self._step_fn = step_fn

    def run_interval(self, alloc: Allocation,
                     duration_ms: float) -> IntervalStats:
        knobs = StreamKnobs(
            buffer_units=alloc.cache_units,
            bandwidth_mbps=alloc.bandwidth,
            prefetch_on=alloc.prefetch_on,
        )
        throughput, wait_ms, curves = self._step_fn(duration_ms, knobs)
        return IntervalStats(
            ipc=as_f64(throughput, self.device),
            queuing_delay_ns=as_f64(wait_ms, self.device) * 1e6,
            utility_curves=as_f64(curves, self.device),
        )
