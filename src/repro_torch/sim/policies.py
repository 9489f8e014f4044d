"""The manager-family registry and the auction/QoS boundary allocators
(counterpart of :mod:`repro.sim.policies`).

The registry is a copy: the same 14 families, in the same order, with the
same Table-3 modes, timeline variants, boundary-branch ids, bank counts
and Fig. 5 static-grid vocabularies, so ``MANAGER_NAMES``, every sweep
and :func:`repro_torch.sim.static_search.registry_families` derive from
one list.  Each family's ``host_golden`` (its loop on the scalar plant)
is attached by :mod:`repro_torch.sim.managers`.

:func:`auction_allocate` and :func:`qos_allocate` are the tensor
counterparts of ``auction_allocate_jax`` / ``qos_allocate_jax`` (same op
order).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.types import Mode, PrefetchMode

#: Cache / bandwidth boundary allocator branch ids.
CACHE_LOOKAHEAD, CACHE_AUCTION, CACHE_QOS = 0, 1, 2
CACHE_POLICY_NAMES: Tuple[str, ...] = ("lookahead", "auction", "qos")
BW_ALG1, BW_AUCTION, BW_QOS = 0, 1, 2
BW_POLICY_NAMES: Tuple[str, ...] = ("alg1", "auction", "qos")

#: Per-client auction budget (only spend proportions matter).
AUCTION_BUDGET = 1.0
AUCTION_EPS = 1e-12

#: QoS family tunables: slowdown bound and violation boost gain.
QOS_SLOWDOWN_BOUND = 1.05
QOS_VIOLATION_GAIN = 8.0


class UnknownManagerError(ValueError):
    """An unregistered manager-family name reached a sweep entry point;
    ``valid`` lists the names the caller accepts (its ``extra`` names,
    then the registered families)."""

    def __init__(self, name: str, extra: Tuple[str, ...] = ()):
        valid = list(extra) + manager_names()
        super().__init__(
            f"unknown manager {name!r}; registered families: {valid}")
        self.name = name
        self.valid = valid


@dataclasses.dataclass
class PolicyFamily:
    """One manager family: Table-3 ``modes`` for the classic families
    (``None`` for CPpf's variant timeline and the registry policies), the
    timeline ``variant``, the boundary-branch ids, the bank count, the
    Fig. 5 static-grid vocabulary and the scalar host loop.

    ``static_grid`` holds plain kwargs of
    :class:`repro_torch.sim.static_search.FamilySpec` (``manage_cache`` /
    ``manage_bw`` / ``manage_pf`` / ``pf_all_on`` / ``bandwidth_banks``),
    so the registry never imports the search."""

    name: str
    modes: Optional[Tuple[Mode, Mode, PrefetchMode]] = None
    variant: str = "fig8"              # "fig8" | "cppf"
    cache_policy: int = CACHE_LOOKAHEAD
    bw_policy: int = BW_ALG1
    bandwidth_banks: int = 1
    static_grid: Optional[Dict[str, object]] = None
    #: ``(plant, total_ms, params) -> ManagerResult``: the family's loop on
    #: the scalar plant, attached by :mod:`repro_torch.sim.managers` (the
    #: registry imports no plant).
    host_golden: Optional[Callable] = None


REGISTRY: Dict[str, PolicyFamily] = {}


def register(family: PolicyFamily) -> PolicyFamily:
    if family.name in REGISTRY:
        raise ValueError(f"family {family.name!r} already registered")
    REGISTRY[family.name] = family
    return family


def manager_names() -> List[str]:
    """Registry insertion order — the manager-name list of every sweep."""
    return list(REGISTRY)


def table3_modes() -> Dict[str, Tuple[Mode, Mode, PrefetchMode]]:
    """The classic mode-combination families (``modes`` is not ``None``)."""
    return {name: fam.modes for name, fam in REGISTRY.items()
            if fam.modes is not None}


def get_family(name: str) -> PolicyFamily:
    try:
        return REGISTRY[name]
    except KeyError:
        raise UnknownManagerError(name) from None


def validate_manager_names(names, extra: Tuple[str, ...] = ()) -> None:
    """Raise :class:`UnknownManagerError` on the first unregistered name;
    ``extra`` admits caller-specific pseudo-families on top of the
    registry."""
    for name in names:
        if name not in REGISTRY and name not in extra:
            raise UnknownManagerError(name, tuple(extra))


# --------------------------------------------------------------------- #
# boundary allocators of the auction / QoS families
# --------------------------------------------------------------------- #

def _shares(weights: torch.Tensor, n: int) -> torch.Tensor:
    """Pro-rata shares with the Algorithm-1 zero-total fallback (1/n)."""
    total = weights.sum(dim=-1, keepdim=True)
    return torch.where(total > 0,
                       weights / torch.where(total > 0, total, 1.0),
                       1.0 / n)


def largest_remainder_round(target: torch.Tensor,
                            total_units: int) -> torch.Tensor:
    """Round float targets to int32 summing exactly to capacity: floor,
    then the leftover units to the largest fractional parts (stable, so
    equal fractions go to the lowest client index)."""
    base = torch.floor(target)
    frac = target - base
    deficit = torch.round(total_units - base.sum(dim=-1)).to(torch.int32)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return (base + (rank < deficit[..., None])).to(torch.int32)


def _cache_desire(curves: torch.Tensor, mw_f: torch.Tensor) -> torch.Tensor:
    """Hits gained going from the floor to the whole cache, >= 0."""
    top = curves[..., -1]
    at_min = torch.gather(curves, -1, mw_f[..., None].long())[..., 0]
    return torch.clamp(top - at_min, min=0.0)


def auction_allocate(curves, bw_delay, *, min_ways, total_units: int,
                     min_bandwidth, total_bandwidth: float):
    """CARMA-style auction over cache and bandwidth (arxiv 1710.00073):
    each client splits a unit budget by its mean-normalized desires, and
    both resources go pro-rata in spend over the floors.

    ``curves`` ``(..., n, U+1)``, ``bw_delay`` ``(..., n)``; ``min_ways``
    and ``min_bandwidth`` broadcast against ``(..., n)``.  Returns int32
    units summing to ``total_units`` and bandwidth summing to
    ``total_bandwidth``.
    """
    n = bw_delay.shape[-1]
    mw = torch.broadcast_to(min_ways, bw_delay.shape).to(bw_delay.dtype)
    cd = _cache_desire(curves, mw)
    cd_n = cd / torch.clamp(cd.mean(dim=-1, keepdim=True), min=AUCTION_EPS)
    bd_n = bw_delay / torch.clamp(
        bw_delay.mean(dim=-1, keepdim=True), min=AUCTION_EPS)
    frac_cache = cd_n / (cd_n + bd_n + AUCTION_EPS)
    spend_cache = AUCTION_BUDGET * frac_cache
    spend_bw = AUCTION_BUDGET - spend_cache

    target = mw + _shares(spend_cache, n) * (
        total_units - mw.sum(dim=-1, keepdim=True))
    units = largest_remainder_round(target, total_units)
    min_bw = torch.as_tensor(min_bandwidth, dtype=bw_delay.dtype,
                             device=bw_delay.device)
    bandwidth = min_bw + _shares(spend_bw, n) * (
        total_bandwidth - min_bw * n)
    return units, bandwidth


def qos_allocate(curves, bw_delay, slowdown, *, min_ways, total_units: int,
                 min_bandwidth, total_bandwidth: float, bound, gain):
    """QoS-constrained allocation (arxiv 1911.05114): demand-proportional
    shares, each client's weight boosted by ``1 + gain * max(slowdown -
    bound, 0)``; ``bound``/``gain`` may be per-row ``(..., 1)`` tensors."""
    n = bw_delay.shape[-1]
    mw = torch.broadcast_to(min_ways, bw_delay.shape).to(bw_delay.dtype)
    boost = 1.0 + gain * torch.clamp(slowdown - bound, min=0.0)
    cache_w = _cache_desire(curves, mw) * boost
    bw_w = bw_delay * boost

    target = mw + _shares(cache_w, n) * (
        total_units - mw.sum(dim=-1, keepdim=True))
    units = largest_remainder_round(target, total_units)
    min_bw = torch.as_tensor(min_bandwidth, dtype=bw_delay.dtype,
                             device=bw_delay.device)
    bandwidth = min_bw + _shares(bw_w, n) * (total_bandwidth - min_bw * n)
    return units, bandwidth


# --------------------------------------------------------------------- #
# the registered families (same order as the reference registry)
# --------------------------------------------------------------------- #

def _grid(**kwargs) -> Dict[str, object]:
    return kwargs


register(PolicyFamily(
    "baseline",
    modes=(Mode.UNPARTITIONED, Mode.UNPARTITIONED, PrefetchMode.OFF),
    static_grid=_grid()))
register(PolicyFamily(
    "equal off", modes=(Mode.EQUAL, Mode.EQUAL, PrefetchMode.OFF),
    static_grid=_grid()))
register(PolicyFamily(
    "equal on", modes=(Mode.EQUAL, Mode.EQUAL, PrefetchMode.ON),
    static_grid=_grid(pf_all_on=True)))
register(PolicyFamily(
    "only cache",
    modes=(Mode.DYNAMIC, Mode.UNPARTITIONED, PrefetchMode.OFF),
    static_grid=_grid(manage_cache=True)))
register(PolicyFamily(
    "only bw", modes=(Mode.UNPARTITIONED, Mode.DYNAMIC, PrefetchMode.OFF),
    static_grid=_grid(manage_bw=True)))
register(PolicyFamily(
    "only pref",
    modes=(Mode.UNPARTITIONED, Mode.UNPARTITIONED, PrefetchMode.DYNAMIC),
    static_grid=_grid(manage_pf=True)))
register(PolicyFamily(
    "bw+pref",
    modes=(Mode.UNPARTITIONED, Mode.DYNAMIC, PrefetchMode.DYNAMIC),
    static_grid=_grid(manage_bw=True, manage_pf=True)))
register(PolicyFamily(
    "bw+cache", modes=(Mode.DYNAMIC, Mode.DYNAMIC, PrefetchMode.OFF),
    static_grid=_grid(manage_cache=True, manage_bw=True)))
register(PolicyFamily(
    "cache+pref",
    modes=(Mode.DYNAMIC, Mode.UNPARTITIONED, PrefetchMode.DYNAMIC),
    static_grid=_grid(manage_cache=True, manage_pf=True)))
register(PolicyFamily(
    "CPpf", variant="cppf",
    static_grid=_grid(manage_cache=True, pf_all_on=True)))
register(PolicyFamily(
    "CBP", modes=(Mode.DYNAMIC, Mode.DYNAMIC, PrefetchMode.DYNAMIC),
    static_grid=_grid(manage_cache=True, manage_bw=True, manage_pf=True)))
register(PolicyFamily(
    "auction", cache_policy=CACHE_AUCTION, bw_policy=BW_AUCTION,
    static_grid=_grid(manage_cache=True, manage_bw=True)))
register(PolicyFamily(
    "qos", cache_policy=CACHE_QOS, bw_policy=BW_QOS,
    static_grid=_grid(manage_cache=True, manage_bw=True)))
register(PolicyFamily(
    "bank bw", bandwidth_banks=4,
    static_grid=_grid(manage_bw=True, bandwidth_banks=4)))
