"""Batched UCP Lookahead cache partitioning, paper §3.2.1 (counterpart of
:mod:`repro.core.cache_controller_jax`).

The greedy itself is the hand-written CUDA kernel
(:mod:`repro_torch.kernels.lookahead_greedy`) for tensors on the card and
its plain PyTorch version for tensors on the CPU; both feed the same
zero-utility spread (:func:`_zero_spread`).  Parity contract: allocations
equal the numpy golden (:func:`repro.core.cache_controller.
lookahead_allocate` / ``cppf_allocate``) exactly, under the shared
tie-breaks (lowest client index wins equal marginal utility; smallest step
wins within a client; the spread orders by remaining gain, stable).

:class:`CacheController` (counterpart of :class:`repro.core.
cache_controller.CacheController`) is the stateful plants' allocator: it
runs this batched greedy on the curves' device, or the host golden
(:mod:`repro_torch.core.cache_controller_numpy`) when asked.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cache_controller_numpy
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.kernels.lookahead_greedy import lookahead_greedy

_I32 = torch.int32


def _zero_spread(curves, alloc, balance, active, remaining):
    """Distribute each row's undistributed balance over its active clients
    by remaining potential gain ``curve[remaining] - curve[alloc]`` (stable
    order): ``balance // n_act`` each, one more to the first
    ``balance % n_act``."""
    B, n, _ = curves.shape
    cur = torch.gather(curves, 2, alloc[:, :, None].long())[:, :, 0]
    top = torch.gather(
        curves, 2,
        remaining.long()[:, None, None].expand(B, n, 1))[:, :, 0]
    key = torch.where(active, -(top - cur), torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)          # inverse permutation
    n_act = torch.clamp(active.sum(dim=-1, dtype=_I32), min=1)     # (B,)
    share = (torch.div(balance[:, None], n_act[:, None],
                       rounding_mode="floor")
             + (rank < torch.remainder(balance, n_act)[:, None]))
    need = balance > 0
    return torch.where(need[:, None] & active, alloc + share, alloc)


def _greedy_core(curves, min_units, active, remaining, total_units: int):
    """Greedy (kernel on the card, plain version on the CPU) + spread.

    ``curves`` ``(B, n, U+1)`` f64, ``min_units``/``remaining`` ``(B,)``
    int, ``active`` ``(B, n)`` bool; returns ``(B, n)`` int32.
    """
    curves = curves.contiguous()
    min32 = min_units.to(_I32).contiguous()
    rem32 = remaining.to(_I32).contiguous()
    alloc, balance = lookahead_greedy(
        curves, min32, active.to(_I32).contiguous(), rem32,
        total_units=int(total_units))
    return _zero_spread(curves, alloc, balance, active, rem32)


def lookahead_traced(curves, min_units, total_units: int):
    """Lookahead over ``(B, n, U+1)`` curves on their device ->
    ``(B, n)`` int32 (every client competes)."""
    B, n, _ = curves.shape
    return _greedy_core(
        curves, min_units,
        torch.ones((B, n), dtype=torch.bool, device=curves.device),
        torch.full((B,), total_units, dtype=_I32, device=curves.device),
        total_units)


def lookahead_masked_traced(curves, min_units, active, total_units: int):
    """CPpf allocation on device: inactive clients pinned at the floor,
    the greedy over the active subset with the capacity left after
    pinning; rows with no active client split evenly, remainder to the
    lowest indices."""
    B, n, _ = curves.shape
    min32 = min_units.to(_I32)
    remaining = total_units - min32 * (n - active.sum(dim=-1, dtype=_I32))
    out = _greedy_core(curves, min_units, active, remaining, total_units)
    none_active = ~active.any(dim=-1)
    extra = total_units - n * min32
    even = (min32[:, None]
            + torch.div(extra[:, None], n, rounding_mode="floor")
            + (torch.arange(n, dtype=_I32, device=curves.device)[None, :]
               < torch.remainder(extra, n)[:, None]))
    return torch.where(none_active[:, None], even, out)


def _validate(curves: np.ndarray, total_units: int,
              min_units: np.ndarray) -> None:
    if curves.shape[-1] != total_units + 1:
        raise ValueError(
            f"utility curves must have {total_units + 1} points, "
            f"got {curves.shape[-1]}")
    n = curves.shape[-2]
    if np.any(min_units * n > total_units):
        raise ValueError("min_units * n exceeds capacity")


def _prepare(utility_curves, total_units: int, min_units, device):
    curves = np.asarray(utility_curves, dtype=np.float64)
    if curves.ndim < 2:
        raise ValueError("utility curves must be at least 2-D")
    batch_shape = curves.shape[:-2]
    flat = curves.reshape((-1,) + curves.shape[-2:])
    if flat.shape[0] == 0:
        raise ValueError("empty batch")
    mus = np.array(np.broadcast_to(
        np.asarray(min_units, dtype=np.int64), batch_shape).reshape(-1))
    _validate(curves, total_units, mus)
    dev = resolve_device(device)
    return (batch_shape, torch.as_tensor(flat, dtype=F64, device=dev),
            torch.as_tensor(mus, device=dev), dev)


def _finish(out: torch.Tensor, batch_shape, total_units: int) -> np.ndarray:
    out = out.cpu().numpy().astype(np.int64)
    if not (out.sum(axis=-1) == total_units).all():
        raise RuntimeError("Lookahead allocation does not sum to capacity")
    return out.reshape(batch_shape + out.shape[-1:])


def lookahead_allocate(utility_curves, total_units: int, min_units=4,
                       device: DeviceLike = None) -> np.ndarray:
    """Batched Lookahead: ``(..., n, U+1)`` curves -> ``(..., n)`` int64.

    Counterpart of :func:`repro.core.cache_controller_jax.
    lookahead_allocate`; runs on ``device`` (``None``: the card).
    """
    batch_shape, flat, mus, _dev = _prepare(
        utility_curves, total_units, min_units, device)
    return _finish(lookahead_traced(flat, mus, int(total_units)),
                   batch_shape, total_units)


def lookahead_allocate_masked(utility_curves, total_units: int, min_units,
                              active, device: DeviceLike = None
                              ) -> np.ndarray:
    """Batched CPpf allocation (counterpart of
    :func:`repro.core.cache_controller_jax.lookahead_allocate_masked`)."""
    batch_shape, flat, mus, dev = _prepare(
        utility_curves, total_units, min_units, device)
    n = flat.shape[1]
    act = np.array(np.broadcast_to(np.asarray(active, dtype=bool),
                                   batch_shape + (n,)).reshape(-1, n))
    out = lookahead_masked_traced(
        flat, mus, torch.as_tensor(act, device=dev), int(total_units))
    return _finish(out, batch_shape, total_units)


def lookahead_allocate_grouped(curve_groups, total_units_list, min_units=4,
                               device: DeviceLike = None) -> list:
    """Lookahead over groups with *different* capacities (counterpart of
    :func:`repro.core.cache_controller_jax.lookahead_allocate_grouped`).

    ``curve_groups`` holds one ``(B_g, n_g, U_g + 1)`` float64 batch per
    capacity ``U_g`` in ``total_units_list``; ``min_units`` is a scalar or
    one scalar / ``(B_g,)`` array per group.  Returns one ``(B_g, n_g)``
    int64 allocation per group, equal row by row to
    :func:`lookahead_allocate`.

    The greedy kernel takes one capacity (one curve width) per launch, so
    each group is its own launch; curves are never padded to a common
    width, which would change the greedy's candidates.
    """
    if len(curve_groups) != len(total_units_list):
        raise ValueError("one total_units per curve group required")
    if len(curve_groups) == 0:
        raise ValueError("empty group list")
    if np.isscalar(min_units):
        min_units = [min_units] * len(curve_groups)
    dev = resolve_device(device)
    prepared = []
    for curves, units, mus in zip(curve_groups, total_units_list, min_units):
        curves = np.asarray(curves, dtype=np.float64)
        if curves.ndim != 3:
            raise ValueError("grouped curves must be (B, n, U + 1)")
        if curves.shape[0] == 0:
            raise ValueError("empty batch")
        mus = np.array(np.broadcast_to(
            np.asarray(mus, dtype=np.int64), curves.shape[:1]))
        _validate(curves, int(units), mus)
        prepared.append((curves, int(units), mus))
    outs = [lookahead_traced(torch.as_tensor(c, dtype=F64, device=dev),
                             torch.as_tensor(m, device=dev), units)
            for c, units, m in prepared]
    return [_finish(o, c.shape[:1], units)
            for o, (c, units, _m) in zip(outs, prepared)]


class CacheController:
    """The Lookahead allocator of a plant (counterpart of
    :class:`repro.core.cache_controller.CacheController`).

    ``allocate`` takes ``(..., n, total_units + 1)`` curves, as a tensor
    or an array, and returns the ``(..., n)`` allocation as an int64
    tensor on the curves' device (a CPU tensor for an array).  Two
    backends:

    * ``"device"``: one batched greedy over every leading row on the
      curves' device (:func:`lookahead_traced` /
      :func:`lookahead_masked_traced`), so on the card each call launches
      ``csrc/lookahead_greedy.cu`` once; on the CPU it runs the kernel's
      plain version.  The reference's ``"jax"`` and ``"pallas"`` backends
      both name this one.
    * ``"numpy"``: the host golden
      (:mod:`repro_torch.core.cache_controller_numpy`), row by row.
    """

    def __init__(self, total_units: int, min_units: int = 4,
                 backend: str = "device"):
        backend = {"jax": "device", "pallas": "device"}.get(backend, backend)
        if backend not in ("numpy", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        self.total_units = total_units
        self.min_units = min_units
        self.backend = backend

    def _prepare(self, utility_curves, min_units):
        curves = torch.as_tensor(utility_curves, dtype=F64)
        if curves.dim() < 2:
            raise ValueError("utility curves must be at least 2-D")
        batch_shape = tuple(curves.shape[:-2])
        mu = self.min_units if min_units is None else min_units
        mus = np.array(np.broadcast_to(
            np.asarray(mu, dtype=np.int64), batch_shape).reshape(-1))
        _validate(curves, self.total_units, mus)
        return curves, batch_shape, mus

    def _host(self, golden, curves, batch_shape, mus, *extra):
        flat = curves.reshape((-1,) + tuple(curves.shape[-2:]))
        flat = flat.cpu().numpy()
        extra = [e.reshape(flat.shape[:2]) for e in extra]
        out = np.stack([golden(flat[b], self.total_units, int(mus[b]),
                               *[e[b] for e in extra])
                        for b in range(flat.shape[0])])
        return torch.as_tensor(out.reshape(batch_shape + out.shape[-1:]),
                               device=curves.device)

    def allocate(self, utility_curves, min_units=None) -> torch.Tensor:
        """Lookahead over ``(..., n, U+1)`` curves -> ``(..., n)`` int64.

        ``min_units`` overrides the configured floor, as a scalar or per
        leading row (how the sweep batches ``CBPParams.min_ways``).
        """
        curves, batch_shape, mus = self._prepare(utility_curves, min_units)
        if self.backend == "numpy":
            return self._host(cache_controller_numpy.lookahead_allocate,
                              curves, batch_shape, mus)
        n = curves.shape[-2]
        flat = curves.reshape((-1, n, self.total_units + 1))
        out = lookahead_traced(flat, torch.as_tensor(mus, device=flat.device),
                               self.total_units)
        return out.to(torch.int64).reshape(batch_shape + (n,))

    def allocate_masked(self, utility_curves, active,
                        min_units=None) -> torch.Tensor:
        """CPpf allocation over ``(..., n, U+1)`` curves: clients where
        ``active`` (``(..., n)`` bool) is false are pinned at the floor,
        the rest of the capacity is UCP-partitioned among the others."""
        curves, batch_shape, mus = self._prepare(utility_curves, min_units)
        n = curves.shape[-2]
        act = torch.broadcast_to(
            torch.as_tensor(active, dtype=torch.bool, device=curves.device),
            batch_shape + (n,))
        if self.backend == "numpy":
            return self._host(cache_controller_numpy.cppf_allocate,
                              curves, batch_shape, mus, act.cpu().numpy())
        flat = curves.reshape((-1, n, self.total_units + 1))
        out = lookahead_masked_traced(
            flat, torch.as_tensor(mus, device=flat.device),
            act.reshape(-1, n), self.total_units)
        return out.to(torch.int64).reshape(batch_shape + (n,))
