"""Per-device cost of one traced step (counterpart of
:mod:`repro.launch.hlo_parse`).

The reference compiles a step and parses its post-SPMD HLO: dot and
convolution FLOPs, HBM bytes at fusion interfaces and collective bytes by
kind, with ring-model wire bytes, each scaled by loop trip counts.  Eager
PyTorch has no HLO, so nothing is parsed here: the step is run once under
two dispatch modes (:class:`CostCounter`), on ``meta`` tensors and a fake
process group where it is a dry run, and every op is counted as it runs.
A Python loop runs its body once per trip, so there is no trip count to
read.

* **FLOPs per device** are ``torch.utils.flop_counter``'s formulas on each
  op that a rank runs on its own shards: the local ops that DTensor
  dispatches a DTensor op to, and the plain ops of code that runs on
  shards (:func:`repro_torch.distributed.on_shards`).  This is the exact
  count for rank 0 (on an uneven split, the rank with the larger pieces).
  ``flops_global`` counts each DTensor op once at its global shape, and
  each plain op on shards times the number of distinct pieces it runs on
  (the product of the mesh dimensions along which its inputs are
  ``Shard`` or ``Partial``); without a mesh both are one count.
* **HBM bytes** are the local bytes of every op's inputs and outputs, views
  and allocations without a write left out: the port's model of unfused
  eager traffic, where the reference counts XLA's fusion interfaces.
* **Collectives** are the functional collectives DTensor issues, under the
  reference's kind names (:data:`COLLECTIVES`); each one's bytes are its
  local output's and its group is its mesh dimension's; the wire bytes
  follow the reference's ring model (:func:`wire_bytes`).  On a ``"cpu"``
  mesh DTensor runs an all-to-all as an all-gather and a local chunk; each
  such all-gather is counted as the all-gather it is and also in
  ``all_to_all_as_all_gather``.
* **Live bytes**: the storages of the step's arguments and of every local
  op's outputs, each dropped when it is freed; the peak is the per-device
  peak estimate.

DTensor derives a DTensor op's output shape by running it on fake global
tensors first; those runs are not the rank's work and are left out (an
active ``FakeTensorMode``, as ``torch.distributed._tools.mem_tracker``
tells them apart).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import distributed as D

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: The functional collectives (``torch.ops._c10d_functional``, the legacy
#: ``c10d_functional`` and DTensor's own all-to-all) by the reference's
#: kind names.
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
#: Functional ops that move nothing: a wait, an autograd wrapper.
_NOT_COLLECTIVE = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_wire_bytes: float = 0.0
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    flops_global: float = 0.0
    all_to_all_as_all_gather: int = 0

    def add(self, other: "CostSummary", times: float = 1.0):
        self.flops += other.flops * times
        self.hbm_bytes += other.hbm_bytes * times
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = (
                self.collective_bytes.get(k, 0.0) + v * times)
        self.collective_wire_bytes += other.collective_wire_bytes * times
        for k, v in other.collective_count.items():
            self.collective_count[k] = (
                self.collective_count.get(k, 0) + int(v * times))
        self.flops_global += other.flops_global * times
        self.all_to_all_as_all_gather += int(
            other.all_to_all_as_all_gather * times)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Ring-model bytes that cross each device's links for one collective
    of ``kind`` whose per-device output is ``nbytes``, over a group of
    ``g`` devices (the reference's ``HloModuleCosts._collective``)."""
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)            # out is the scattered shard
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes                          # collective-permute


def _under_fake() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch stack: DTensor's
    output-shape runs, not a rank's work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if D.is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> Optional[str]:
    """The kind of a collective op (a reference name where one applies,
    else the op's own name), or None for any other op."""
    ns = func.namespace
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if name in _NOT_COLLECTIVE or (ns == "_dtensor" and name not in KINDS):
        return None
    return KINDS.get(name, name)


def _group_size(args, kwargs) -> int:
    """The size of the group a functional collective runs over, from its
    group name (the reference's default of 2 where none is found)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    for name in reversed(names):
        try:
            return _resolve_process_group(name).size()
        except Exception:   # noqa: BLE001 - a reduce op's name, not a group
            continue
    return 2


def _in_cpu_all_to_all() -> bool:
    """Whether the caller is DTensor's all-to-all on a ``"cpu"`` mesh
    (``shard_dim_alltoall``), which runs an all-gather and a chunk."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class _LiveBytes:
    """Bytes of the storages seen so far that are still alive, and their
    peak (the counterpart of ``MemTracker``'s per-device total).  A
    storage's Python object lives as long as the storage does, so a weak
    reference to it says when it is freed."""

    def __init__(self):
        self._refs: Dict[int, weakref.ref] = {}
        self.live = 0
        self.peak = 0

    def _freed(self, nbytes: int, key: int) -> None:
        self.live -= nbytes
        del self._refs[key]

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage if it is new."""
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, n=n, key=key: self._freed(n, key))
        self.live += n
        self.peak = max(self.peak, self.live)


class _Local(TorchDispatchMode):
    """The inner mode: every op a rank runs on its own tensors."""

    def __init__(self, cost: CostSummary, live: _LiveBytes):
        super().__init__()
        self.cost, self.live = cost, live
        #: "op[input shapes]" -> FLOPs, for the ops that have any
        self.by_op: Dict[str, float] = {}
        #: the shape of every local tensor an op made
        self.shapes: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_type(types):
            return NotImplemented     # DTensor runs it as local ops
        if _under_fake():
            return func(*args, **kwargs)
        parts = _decomposed(self, func, args, kwargs)
        if parts is not NotImplemented:
            return parts
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        outs = _tensors(out)
        if kind is not None:
            nbytes = sum(_nbytes(t) for t in outs)
            g = _group_size(args, kwargs)
            c = self.cost
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) \
                + nbytes
            c.collective_count[kind] = c.collective_count.get(kind, 0) + 1
            c.collective_wire_bytes += wire_bytes(kind, nbytes, g)
            if kind == "all-gather" and _in_cpu_all_to_all():
                c.all_to_all_as_all_gather += 1
        flops = _flops(func, args, kwargs, out)
        if flops:
            self.cost.flops += flops
            key = f"{func}{[tuple(t.shape) for t in _tensors(args)]}"
            self.by_op[key] = self.by_op.get(key, 0.0) + flops
        if not _moves_nothing(func):
            self.cost.hbm_bytes += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self.live.track(t)
            self.shapes.add(tuple(t.shape))
        return out


class _Global(TorchDispatchMode):
    """The outer mode: DTensor ops at their global shapes, and plain ops
    outside them (code on shards, or no mesh at all), each weighed by the
    number of distinct pieces its inputs vary over."""

    def __init__(self, cost: CostSummary):
        from torch.utils.weak import WeakTensorKeyDictionary

        super().__init__()
        self.cost = cost
        #: plain tensor -> the mesh dimensions (names) its value varies on
        self.varies = WeakTensorKeyDictionary()
        self.sizes: Dict[str, int] = {}

    def observe_shards(self, local_args, ins, mesh) -> None:
        """Called by :func:`repro_torch.distributed.on_shards` with a
        function's local arguments and their placements."""
        names, sizes = D.mesh_axes(mesh)
        self.sizes.update(sizes)
        for arg, pls in zip(local_args, ins):
            if isinstance(arg, torch.Tensor) and pls is not None:
                self.varies[arg] = frozenset(
                    n for n, p in zip(names, pls)
                    if p.is_shard() or p.is_partial())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        parts = _decomposed(self, func, args, kwargs)
        if parts is not NotImplemented:
            return parts
        out = func(*args, **kwargs)
        if _is_dtensor_type(types):
            self.cost.flops_global += _flops(func, args, kwargs, out)
            return out
        if len(self.varies):
            dims = frozenset().union(*(
                self.varies.get(t, frozenset())
                for t in _tensors((args, kwargs))))
            if dims:
                for t in _tensors(out):
                    self.varies[t] = dims
            pieces = 1
            for n in dims:
                pieces *= self.sizes[n]
        else:
            pieces = 1
        self.cost.flops_global += pieces * _flops(func, args, kwargs, out)
        return out


def _decomposed(mode, func, args, kwargs):
    """As ``FlopCounterMode`` does, an op with no FLOP formula run as its
    decomposition where it has one (each part counted by ``mode``), else
    ``NotImplemented``."""
    from torch.utils.flop_counter import flop_registry

    if (func._overloadpacket in flop_registry
            or func is torch.ops.prim.device.default
            or isinstance(func, torch._ops.HigherOrderOperator)):
        return NotImplemented
    with mode:
        return func.decompose(*args, **kwargs)


def _flops(func, args, kwargs, out) -> float:
    """``FlopCounterMode``'s count of one op (0 for an op it has no
    formula for)."""
    from torch.utils.flop_counter import flop_registry

    f = flop_registry.get(func._overloadpacket)
    return float(f(*args, **kwargs, out_val=out)) if f is not None else 0.0


def _moves_nothing(func) -> bool:
    """A view (an alias of its input), a bare allocation or a wait."""
    name = func._overloadpacket.__name__
    return (func.is_view or name in _NOT_COLLECTIVE
            or name in ("empty", "empty_strided", "empty_like", "detach",
                        "alias", "lift_fresh"))


class CostCounter:
    """Counts what runs inside ``with CostCounter(*args) as c:`` on this
    rank: ``c.cost`` (:class:`CostSummary`), ``c.argument_bytes`` (the
    local bytes of the tensors in ``args``, each storage once) and
    ``c.peak_bytes`` (the peak of live local bytes, the arguments'
    included); ``c.flops_by_op`` splits ``c.cost.flops`` by op and input
    shapes, and ``c.shapes`` holds the shape of every local tensor an op
    made."""

    def __init__(self, *args):
        self.cost = CostSummary()
        self._live = _LiveBytes()
        for t in _tensors(args):
            self._live.track(_local(t))
        self.argument_bytes = self._live.live
        self._global = _Global(self.cost)
        self._inner = _Local(self.cost, self._live)

    @property
    def peak_bytes(self) -> int:
        return self._live.peak

    @property
    def flops_by_op(self) -> Dict[str, float]:
        return self._inner.by_op

    @property
    def shapes(self) -> set:
        return self._inner.shapes

    def __enter__(self) -> "CostCounter":
        self._inner.__enter__()
        self._global.__enter__()
        D.add_shard_observer(self._global.observe_shards)
        return self

    def __exit__(self, *exc) -> None:
        D.remove_shard_observer(self._global.observe_shards)
        self._global.__exit__(*exc)
        self._inner.__exit__(*exc)


def analyze(fn: Callable, *args, **kwargs) -> CostSummary:
    """The per-device :class:`CostSummary` of ``fn(*args, **kwargs)``, run
    once (the counterpart of ``hlo_parse.analyze(compiled.as_text())``)."""
    return trace(fn, *args, **kwargs)[1]


def trace(fn: Callable, *args, **kwargs
          ) -> Tuple[object, CostSummary, CostCounter]:
    """``fn(*args, **kwargs)`` run once under a :class:`CostCounter` over
    ``args``: its result, the cost and the counter (argument and peak
    bytes)."""
    counter = CostCounter(*args)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.cost, counter
