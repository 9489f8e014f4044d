"""Row and grid sharding over a list of devices (counterpart of the shard
functions of :mod:`repro.distributed`: ``row_shard_count``,
``shard_rows``, ``grid_shard_counts`` and ``shard_grid``).

The reference's ``shard_map`` is one process over many devices; so is
this: the caller's batch is split into equal blocks, each block runs the
caller's single-device worker on its own device, one after another from
the calling thread (kernel launches are asynchronous, so blocks on
different cards overlap), and the blocks' outputs are gathered in row
order onto one device.  Nothing is sent between the blocks.

The devices are a list of :class:`torch.device`.  By default it is every
device of the parameters' type: ``cuda:0 .. cuda:{n-1}`` on the card and
``[cpu]`` on the CPU, so one H100 gives one shard and every caller skips
the split.  :func:`use_devices` sets another list for a block of code,
the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  A list may name
one device many times (``[torch.device("cpu")] * 8``): the tests force
shards so.  A list whose devices are not all of the parameters' type
raises a ``ValueError``; a block that fails on its device raises, and no
block moves to another device.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import torch

DeviceList = Sequence[Union[str, torch.device]]

#: The list set by :func:`use_devices`, process-wide (as the reference's
#: flag is): a worker thread, such as the streaming sweep's, sees it too.
_forced: Optional[List[torch.device]] = None


@contextlib.contextmanager
def use_devices(devices: DeviceList) -> Iterator[List[torch.device]]:
    """Shard over ``devices`` inside the block (repeats allowed)."""
    global _forced
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("use_devices needs at least one device")
    prev, _forced = _forced, devs
    try:
        yield devs
    finally:
        _forced = prev


def device_list(device: Union[str, torch.device, None] = None
                ) -> List[torch.device]:
    """The devices that work on ``device`` (the parameters' device) shards
    over: the :func:`use_devices` list, else every device of its type.
    ``None`` takes the forced list's type, else the card's if there is
    one, else the CPU's."""
    if device is None:
        if _forced is not None:
            device = _forced[0]
        else:
            device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    if _forced is not None:
        wrong = [str(d) for d in _forced if d.type != kind]
        if wrong:
            raise ValueError(
                f"the device list names {wrong}, not of the parameters' "
                f"type {kind!r}")
        return list(_forced)
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def row_shard_count(n_rows: int, device=None) -> int:
    """How many ways a leading batch axis of ``n_rows`` shards: the device
    count clamped to the rows, so a tiny batch never shards wider than it
    has rows; 1 for an empty batch (callers then skip the split)."""
    if n_rows <= 0:
        return 1
    return max(1, min(n_rows, len(device_list(device))))


def grid_shard_counts(n_groups: int, n_rows: int,
                      device=None) -> Tuple[int, int]:
    """Factor the devices into a (group, row) shard grid: each axis
    clamped to its extent; among factorizations using the most devices
    the most balanced (largest ``min(a, b)``) wins, then the most row
    shards.  ``(1, 1)`` on one device or an empty axis."""
    d = len(device_list(device))
    if n_groups <= 0 or n_rows <= 0 or d <= 1:
        return (1, 1)
    best = (1, 1)
    best_key = (1, 1, 1)
    for a in range(1, min(n_groups, d) + 1):
        b = min(n_rows, d // a)
        key = (a * b, min(a, b), b)
        if key > best_key:
            best, best_key = (a, b), key
    return best


# --------------------------------------------------------------------- #
# trees: dicts of leaves.  An input leaf is a tensor, a numpy array or a
# list (per-group Python objects); an output leaf is a tensor.
# --------------------------------------------------------------------- #

def _split(tree, axes: Sequence[int], blocks: Sequence[int],
           index: Sequence[int]):
    """Block ``index`` of every leaf, leaves split on ``axes`` into
    ``blocks`` equal parts each; a list (per-group Python objects) splits
    on its one axis."""
    if isinstance(tree, dict):
        return {k: _split(v, axes, blocks, index) for k, v in tree.items()}
    leaf = tree
    for axis, n, i in zip(axes, blocks, index):
        if isinstance(leaf, list) and axis:
            raise ValueError("a list leaf splits on its first axis only")
        size = len(leaf) if isinstance(leaf, list) else leaf.shape[axis]
        if size % n:
            raise ValueError(
                f"axis {axis} of {size} rows does not split into {n} equal "
                "blocks (the caller pads)")
        step = size // n
        rows = slice(i * step, (i + 1) * step)
        leaf = (leaf[rows] if isinstance(leaf, list)
                else leaf[(slice(None),) * axis + (rows,)])
    return leaf


def _to(tree, device: torch.device):
    """Every tensor of ``tree`` on ``device``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _gather(outs: Sequence, axis: int, device: torch.device):
    """Concatenate the blocks' output trees (dicts of tensors) along
    ``axis`` on ``device``."""
    if isinstance(outs[0], dict):
        return {k: _gather([o[k] for o in outs], axis, device)
                for k in outs[0]}
    return torch.cat([o.to(device) for o in outs], dim=axis)


def _on(device: torch.device):
    """Make ``device`` current for a block's work (a no-op off the card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _devices(dest: torch.device, n: int) -> List[torch.device]:
    """The first ``n`` devices of :func:`device_list` for ``dest``."""
    devs = device_list(dest)
    if len(devs) < n:
        raise ValueError(f"{n} shards need {n} devices; the list has "
                         f"{len(devs)}")
    return devs[:n]


def shard_rows(worker: Callable, n_shards: int,
               gather_to: Union[str, torch.device]) -> Callable:
    """``worker(sharded_tree, replicated_tree)`` over ``n_shards`` devices.

    Every leaf of the first tree splits on its leading axis into
    ``n_shards`` equal blocks (the caller pads), the second tree is copied
    to every device, block ``i`` runs on device ``i`` of
    :func:`device_list` (for ``gather_to``, the parameters' device), and
    the outputs, whose leaves carry the block's rows first, gather in row
    order onto ``gather_to``.
    """
    dest = torch.device(gather_to)

    def run(sharded, replicated):
        devs = _devices(dest, n_shards)
        outs = []
        for i, dev in enumerate(devs):
            with _on(dev):
                outs.append(worker(
                    _to(_split(sharded, (0,), (n_shards,), (i,)), dev),
                    _to(replicated, dev)))
        return _gather(outs, 0, dest)

    return run


def shard_grid(worker: Callable, grid_shards: Tuple[int, int],
               gather_to: Union[str, torch.device]) -> Callable:
    """``worker(grid_tree, group_tree, replicated_tree)`` over a 2-D
    (group x row) grid of ``a * b`` devices.

    ``grid_tree`` leaves carry two leading batch axes ``(K, M, ...)`` and
    split on both; ``group_tree`` leaves carry the group axis alone
    (per-manager flags, or a list of Python objects) and split on it;
    ``replicated_tree`` is copied to every device.  Callers pad K and M to
    multiples of the shard counts.  Block ``(i, j)`` runs on device
    ``i * b + j`` of the list, and the outputs, whose leaves carry the
    block's ``(K/a, M/b, ...)`` axes, gather in (group, row) order onto
    ``gather_to``, as in :func:`shard_rows`.
    """
    a, b = grid_shards
    dest = torch.device(gather_to)

    def run(grid_tree, group_tree, replicated_tree):
        devs = _devices(dest, a * b)
        rows = []
        for i in range(a):
            outs = []
            for j in range(b):
                dev = devs[i * b + j]
                with _on(dev):
                    outs.append(worker(
                        _to(_split(grid_tree, (0, 1), (a, b), (i, j)), dev),
                        _to(_split(group_tree, (0,), (a,), (i,)), dev),
                        _to(replicated_tree, dev)))
            rows.append(_gather(outs, 1, dest))
        return _gather(rows, 0, dest)

    return run
