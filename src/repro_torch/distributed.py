"""Sharding over devices, two ways (counterpart of
:mod:`repro.distributed`).

**Row and grid shards** (``row_shard_count``, ``shard_rows``,
``grid_shard_counts``, ``shard_grid``).  The reference's ``shard_map`` is
one process over many devices; so is this: the caller's batch is split
into equal blocks, each block runs the caller's single-device worker on
its own device, one after another from the calling thread (kernel
launches are asynchronous, so blocks on different cards overlap), and the
blocks' outputs are gathered in row order onto one device.  Nothing is
sent between the blocks.

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

**The training mesh** (``make_mesh``, ``use_mesh``, ``set_dp_axes``,
``spec``, ``constrain``).  The reference trains under a GSPMD mesh: one
process, many devices, and model code pins activations with
``constrain``.  Here a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
axis names (``data``, ``model``, and ``pod`` where it has one) over a
process group of one process a device: gloo on the CPU, NCCL on cards.
:func:`start_ranks` joins a process to its group through a ``file://``
store (no network) and :func:`end_ranks` leaves it.  Parameters,
optimizer state and batches are :class:`~torch.distributed.tensor.DTensor`
values placed by the reference's specs
(:mod:`repro_torch.launch.shardings`): a spec is the reference's
``PartitionSpec`` as a plain tuple, each entry ``None``, an axis name or a
tuple of axis names, and :func:`placements` turns it into the DTensor
placements on a mesh.  Under a mesh, :func:`constrain` redistributes a
DTensor to its spec's placements (data moves, values do not, as with
``with_sharding_constraint``) and refuses a plain tensor; without a mesh
it returns its argument itself, so every single-device path is
unchanged.  The mesh is process-wide, not per thread: on the card the
backward pass, and the recomputation of a rematerialized layer within it,
run on autograd's own threads and must see the same mesh.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.device import DeviceLike, resolve_device

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


# --------------------------------------------------------------------- #
# The training mesh.
# --------------------------------------------------------------------- #

#: Logical axis groups: "dp" spreads over every data-parallel mesh axis.
DP_AXES = ("pod", "data")

#: A spec: one entry a tensor dimension, each None, a mesh axis name or a
#: tuple of names (the reference's ``PartitionSpec`` as a tuple).
Spec = Tuple[Any, ...]

_dp_axes: Tuple[str, ...] = DP_AXES
_mesh = None


def P(*entries) -> Spec:
    """A spec of ``entries``, a one-name tuple written as the name (as
    ``PartitionSpec`` writes it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def set_dp_axes(axes) -> None:
    """Override which mesh axes count as data-parallel ("dp"), e.g.
    ("pod", "data", "model") for pure-DP tiny models."""
    global _dp_axes
    _dp_axes = tuple(axes)


def get_dp_axes() -> Tuple[str, ...]:
    return _dp_axes


def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` is the ambient mesh inside the block."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], dict]:
    """``(axis names, {name: size})`` of a :class:`DeviceMesh` or of any
    stand-in with ``axis_names`` and a ``shape`` mapping (as a JAX
    ``Mesh`` has): the specs need nothing else of a mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


def _resolve_axis(axis, mesh):
    """Map a logical axis (or tuple) to the axes present in ``mesh``."""
    names = mesh_axes(mesh)[0]
    if axis is None:
        return None
    if axis == "dp":
        present = tuple(a for a in get_dp_axes() if a in names)
        return present if present else None
    if isinstance(axis, tuple):
        present = tuple(a for a in axis if a in names)
        return present if present else None
    return axis if axis in names else None


def spec(*axes, mesh=None) -> Spec:
    """A spec against ``mesh`` (default: the ambient mesh; "dp" = all DP
    axes).  Mesh axes already claimed by an earlier entry are dropped from
    later entries (pure-DP mode resolves "dp" to ("data", "model"), so a
    later explicit "model" entry becomes None)."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return (None,) * len(axes)
    used = set()
    out = []
    for a in axes:
        r = _resolve_axis(a, mesh)
        if r is None:
            out.append(None)
            continue
        if isinstance(r, tuple):
            r = tuple(x for x in r if x not in used)
            used.update(r)
            out.append(r if r else None)
        else:
            if r in used:
                out.append(None)
            else:
                used.add(r)
                out.append(r)
    return P(*out)


def placements(sp: Spec, mesh) -> list:
    """The DTensor placements of spec ``sp`` on ``mesh``: a tensor
    dimension ``i`` whose entry names mesh axes is ``Shard(i)`` on each of
    them of more than one device (a tuple in the mesh's major-to-minor
    order), every other mesh dimension ``Replicate()`` (an axis of one
    device holds the whole dimension either way, and DTensor's views
    refuse to reshape a dimension it calls sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(sp):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"major-to-minor order {names}")
        for j in dims:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} shards two "
                                 f"dimensions in {sp}")
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` laid out by ``spec(*axes)`` on the ambient mesh, the
    counterpart of ``with_sharding_constraint``: without a mesh ``x``
    itself; under one a DTensor redistributed (data moves, values stay)
    and a plain tensor refused, since whatever made it lost its layout and
    no silent gather may stand in for one."""
    mesh = get_mesh()
    if mesh is None:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constrain{axes}: a plain tensor of shape {tuple(x.shape)} "
            "under a mesh (its producer lost the layout)")
    return x.redistribute(x.device_mesh, placements(
        _dividing(spec(*axes, mesh=mesh), x.shape, mesh), mesh))


def _dividing(sp: Spec, shape, mesh) -> Spec:
    """``sp`` with each entry's minor axes dropped until their sizes
    divide the dimension: where the reference pads an uneven shard,
    DTensor's views refuse one, so the dimension is split fewer ways (a
    layout, not a value)."""
    sizes = mesh_axes(mesh)[1]
    out = []
    for entry, dim in zip(sp, shape):
        axes = list(entry if isinstance(entry, tuple) else
                    (entry,) if entry else ())
        while axes and (dim % math.prod(sizes[a] for a in axes)
                        or dim < math.prod(sizes[a] for a in axes)):
            axes.pop()
        out.append(tuple(axes) if axes else None)
    return P(*out)


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` ready for a reshape that splits dimension ``dim`` into
    ``(outer, rest)``: a DTensor sharded on ``dim`` over mesh axes whose
    sizes do not divide ``outer`` is gathered on ``dim`` first (a DTensor
    view cannot re-cut its shards; values do not change), and its gradient
    comes back in that layout (:func:`pin`).  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    mesh = x.device_mesh
    on = [j for j, p in enumerate(x.placements) if p.is_shard(dim)]
    if outer % math.prod(mesh.size(j) for j in on) == 0:
        return pin(x)
    from torch.distributed.tensor import Replicate
    return x.redistribute(mesh, [Replicate() if j in on else p
                                 for j, p in enumerate(x.placements)])


#: Callbacks ``observe(local_args, ins, mesh)`` run as each function of
#: :func:`on_shards` starts, with its local arguments and their placements
#: (a cost counter's: :mod:`repro_torch.launch.op_costs`).
_shard_observers: List[Callable] = []


def add_shard_observer(observe: Callable) -> None:
    _shard_observers.append(observe)


def remove_shard_observer(observe: Callable) -> None:
    _shard_observers.remove(observe)


def on_shards(fn: Callable, mesh, outs, ins, grads=None) -> Callable:
    """``fn`` run on each rank's shards (``local_map``): its inputs laid
    out by ``ins`` (placements per argument, None for a non-tensor), their
    gradients by ``grads`` (default ``ins``), its outputs read as ``outs``
    (placements per output; ``fn`` returns a tensor for one, a tuple for
    several).  Every placement list is passed as a tuple inside a tuple,
    the form every PyTorch release reads alike."""
    from torch.distributed.tensor.experimental import local_map

    def tup(pls):
        return tuple(None if p is None else tuple(p) for p in pls)

    def body(*local_args):
        for observe in _shard_observers:
            observe(local_args, ins, mesh)
        return fn(*local_args)

    return local_map(body, out_placements=tup(outs), in_placements=tup(ins),
                     in_grad_placements=None if grads is None
                     else tup(grads), device_mesh=mesh)


def foldable(eq: str, *ops: torch.Tensor) -> tuple:
    """The operands of ``torch.einsum(eq, *ops)``, ready for DTensor on
    every PyTorch release.  A product of two operands folds each one's
    batch, free and contracted dimensions into one dimension each (in the
    output's label order, then the contracted labels' first appearance);
    a DTensor view folds a group only where no dimension but its first is
    sharded (newer releases express the rest with strided shards, older
    ones raise), so each such dimension is gathered first.  Plain tensors,
    and einsums of one or of three operands, as they are."""
    if len(ops) != 2 or not any(is_dtensor(o) for o in ops):
        return ops
    from torch.distributed.tensor import Replicate

    lhs, out = eq.replace(" ", "").split("->")
    subs = lhs.split(",")
    spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    width = max(o.dim() - len(s.replace("...", "")) for s, o in
                zip(subs, ops) if "..." in s) if "..." in lhs else 0
    ell = "".join(spare[:width])
    subs = [s.replace("...", ell[width - (o.dim() - len(s) + 3):])
            if "..." in s else s for s, o in zip(subs, ops)]
    out = out.replace("...", ell)
    order = list(dict.fromkeys(out + "".join(subs)))
    ready = []
    for i, (sub, x) in enumerate(zip(subs, ops)):
        if not is_dtensor(x):
            ready.append(x)
            continue
        other = subs[1 - i]
        groups = {}
        for c in sub:
            kind = (c in out, c in other)
            if kind != (False, False):     # summed alone: never folded
                groups.setdefault(kind, []).append(c)
        gather = {sub.index(c) for g in groups.values()
                  for c in sorted(g, key=order.index)[1:]}
        pl = [Replicate() if any(p.is_shard(d) for d in gather) else p
              for p in x.placements]
        ready.append(x.redistribute(x.device_mesh, pl)
                     if pl != list(x.placements) else x)
    return tuple(ready)


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient comes back in ``x``'s own layout: the
    backward of a reshape that merged dimensions splits them again, and
    a DTensor view cannot split a gradient sharded where the forward was
    not (values do not change).  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending partial sum reduced (``Partial`` ->
    ``Replicate``); a plain tensor or a DTensor with none as it is.  A
    gather along a sharded dimension leaves a masked partial, which must
    be reduced before a view of it (DTensor cannot mask the view)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def shard_start(x: torch.Tensor, dim: int) -> int:
    """The first global index along ``dim`` of this rank's shard of the
    DTensor ``x``, split evenly (as :func:`constrain` and the specs split
    it), in the mesh's dimension order."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    index, size = 0, x.shape[dim]
    for j, p in enumerate(x.placements):
        if p.is_shard(dim):
            size //= mesh.size(j)
            index = index * mesh.size(j) + coord[j]
    return index * size


def mesh_context():
    """The context model code runs in under a mesh: plain tensors it makes
    (positions, masks, rope tables) are the same on every rank, so each
    counts as replicated where it meets a DTensor.  A no-op without a
    mesh."""
    if get_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def start_ranks(store: Optional[Union[str, os.PathLike]], rank: int,
                world_size: int, device: DeviceLike = None,
                timeout: Optional[float] = None) -> torch.device:
    """Join this process to a group of ``world_size`` ranks that meet at
    the file ``store`` (a path every rank names, under a temporary
    directory: ``file://``, no network), or, with ``store`` None, at the
    rendezvous ``torchrun`` set up (``env://``).  ``device`` "cpu" takes
    gloo; the default, the card, takes NCCL on card ``rank`` of the host
    and raises without one (no fallback to gloo).  ``timeout`` (seconds)
    bounds each wait of the group's operations (default: the backend's).
    Returns this rank's device."""
    import datetime

    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    init = "env://" if store is None else f"file://{store}"
    dist.init_process_group(backend, init_method=init,
                            rank=rank, world_size=world_size, **kw)
    return dev


def start_fake_ranks(world_size: int, rank: int = 0) -> None:
    """Join this process, as rank ``rank``, to a group of ``world_size``
    ranks that exist in name only (backend ``"fake"``, from
    ``torch.testing._internal.distributed.fake_pg``): its collectives
    return at once and move nothing, so one process traces what one rank
    of a production-size mesh runs, on ``meta`` tensors (the dry run,
    :mod:`repro_torch.launch.dryrun`).  :func:`end_ranks` leaves it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def end_ranks() -> None:
    """Leave the process group (no-op where none is running) and drop the
    ambient mesh."""
    import torch.distributed as dist

    set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = None):
    """A :class:`DeviceMesh` of ``shape`` named ``axis_names`` over the
    running process group, whose size must be ``prod(shape)``; rank ``r``
    is the mesh's ``r``-th device in row-major order.  One process with no
    group running starts a one-rank group first (a ``(1, 1)`` mesh).
    ``device`` "cpu" is a gloo mesh; the default is the card's (NCCL),
    which raises without one.  A fake group (:func:`start_fake_ranks`)
    serves either device type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    size = math.prod(shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)}")
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(
                f"a {tuple(shape)} mesh needs {size} ranks; no group is "
                "running (start_ranks joins each)")
        start_ranks(os.path.join(tempfile.mkdtemp(prefix="mesh_"), "store"),
                    0, 1, dev)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks; the "
                         f"group has {world}")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() not in (want, "fake"):
        raise ValueError(f"a {dev.type} mesh needs a {want} group; the "
                         f"group runs {dist.get_backend()}")
    return DeviceMesh(dev.type, torch.arange(size).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))
