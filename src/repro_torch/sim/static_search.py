"""Fig. 5's static search on tensors (counterpart of
:mod:`repro.sim.static_search`).

The paper's potential study (§2.3 / Fig. 5) searches every static
(cache, bandwidth, prefetch) allocation of each workload, per manager
*family* (the resources it may move), to show that managing all three
resources beats every two-resource subset.

The host layer is a copy of the reference's: each family's grid is
enumerated on the host (:func:`enumerate_grid`: per-resource option
products, sum-feasibility filtered, in ``itertools.product`` order) and
padded to a chunk multiple with a validity mask, by the reference's chunk
rule (:func:`_family_tables`).  The device layer is the reference's
``lax.scan`` as a Python loop over the chunks (:func:`_family_scan`):
each step evaluates the interval model
(:func:`repro_torch.sim.memsys.evaluate`, both regimes partitioned) for
every (workload, config) pair of the chunk and folds a running top-k, or
Pareto front, of weighted speedups, so memory stays at ``W x chunk x n``
whatever the grid's size.  A search is the shared equal-share baseline
evaluation plus one scan per family.

Tie-breaks and rounding.  Among configs of equal weighted speedup the
LOWEST enumeration index wins (cache combinations outermost, then
bandwidth, then prefetch, the last application fastest).  Every
selection is a stable descending sort (``torch.topk`` orders equal values
arbitrarily on the card), and the running entries (earlier chunks, so
lower indices) are merged before the chunk's.  The weighted speedup is
the mean over applications, summed in numpy's order
(:func:`repro_torch.numpy_order.numpy_order_sum`) and divided by ``n`` as
a tensor: two *twin* configs, which give two copies of one application
each other's allocations, score the same per-application values in
another order, and any other summation order splits their tie otherwise
than the numpy golden.  Top-k results are sorted descending with distinct
config indices; slots beyond the number of feasible configs hold
``-inf`` / index ``-1``.

Contract (``tests/test_torch_static_search.py``): on the CPU the top-k
indices equal the reference's numpy backend index for index, weighted
speedups within rtol 1e-12.  On the card (``chip_smoke.py`` phase 12,
``tests/test_torch_static_search_cuda.py``) an index equals the golden's
or names its twin (:func:`is_twin`), since the card's float64 ``exp`` may
differ from glibc's in the last bit; in the banked regime that difference
grows through the fixed point, and banked twins split by the golden's
rounding alone as flat ones do.  Weighted speedups are within rtol 1e-5
of the golden there, the Pareto case within 1e-12.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.device import F64, DeviceLike, resolve_device
from repro_torch.numpy_order import numpy_order_sum
from repro_torch.sim import memsys
from repro_torch.sim.apps import AppArrays, app_fields, from_numpy, stack_mixes
from repro_torch.sim.runner import equal_share

#: Fixed-point iterations of the Fig. 5 protocol (fewer than the plant's
#: 60: static allocations converge fast and the reference always used 40).
FIG5_ITERS = 40

#: Target elements (workloads x configs x apps) per scan step; bounds
#: peak memory at a few hundred MB of f64 temporaries.
CHUNK_ELEMENTS = 1 << 21


class InfeasibleGridError(ValueError):
    """A static config grid has zero feasible configurations.

    Raised with the violated constraint (and, from :func:`search_static`,
    the family name) instead of silently searching an empty grid — an
    empty grid's top-k would be all ``-inf`` scores and ``-1`` indices,
    which downstream argmax/``config`` lookups consume as garbage.
    """


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Which resources a Fig. 5 family may allocate statically.

    Unmanaged resources pin to the equal-share fixed point
    (``StaticOptions.cache_fixed`` / ``bw_fixed``); an unmanaged
    prefetcher is off unless ``pf_all_on`` forces it on for everyone.
    """

    manage_cache: bool = False
    manage_bw: bool = False
    manage_pf: bool = False
    pf_all_on: bool = False
    bandwidth_banks: int = 1     # >1: banked-token bandwidth regime


#: The Fig. 5 manager families (paper §2.3), insertion order = plot order.
FIG5_FAMILIES: Dict[str, FamilySpec] = {
    "equal_on": FamilySpec(pf_all_on=True),
    "only_pref": FamilySpec(manage_pf=True),
    "bw+pref": FamilySpec(manage_bw=True, manage_pf=True),
    "cache+bw": FamilySpec(manage_cache=True, manage_bw=True),
    "cache+pref": FamilySpec(manage_cache=True, manage_pf=True),
    "cache+bw+pref": FamilySpec(manage_cache=True, manage_bw=True,
                                manage_pf=True),
}

#: The two-resource subsets the all-three family is compared against.
FIG5_TWO_RESOURCE = ("bw+pref", "cache+bw", "cache+pref")


def registry_families(
        names: Optional[Sequence[str]] = None) -> Dict[str, FamilySpec]:
    """Manager families' static-grid vocabularies as :class:`FamilySpec`.

    Converts the policy registry's plain ``static_grid`` kwargs
    (:mod:`repro_torch.sim.policies`) into the search's family specs, so
    ``search_static(families=registry_families(["CBP", "bank bw"]))``
    explores exactly the knobs each manager family may move.  Default:
    every registered family.
    """
    from repro_torch.sim import policies

    resolved = policies.manager_names() if names is None else list(names)
    out: Dict[str, FamilySpec] = {}
    for name in resolved:
        fam = policies.get_family(name)   # UnknownManagerError on a typo
        out[name] = FamilySpec(**(fam.static_grid or {}))
    return out


@dataclasses.dataclass(frozen=True)
class StaticOptions:
    """The static design-space option values (paper §2.3 defaults).

    Budgets are per application: a workload of ``n`` apps searches under
    ``sum(cache) <= cache_budget_per_app * n`` (ditto bandwidth), and the
    budgets double as the model's total capacities — exactly the
    ``_exhaustive_best`` protocol.  Replace the option tuples for finer
    or larger grids; they need not contain the fixed points.
    """

    cache_options: Tuple[float, ...] = (8.0, 16.0, 32.0)
    cache_fixed: float = 16.0
    bw_options: Tuple[float, ...] = (2.0, 4.0, 6.0)
    bw_fixed: float = 4.0
    cache_budget_per_app: float = 16.0
    bw_budget_per_app: float = 4.0

    def per_app(self, spec: FamilySpec, n: int):
        """Per-application option tuples for one family."""
        cache = (tuple(float(c) for c in self.cache_options)
                 if spec.manage_cache else (float(self.cache_fixed),))
        bw = (tuple(float(b) for b in self.bw_options)
              if spec.manage_bw else (float(self.bw_fixed),))
        pf = ((0.0, 1.0) if spec.manage_pf
              else ((1.0,) if spec.pf_all_on else (0.0,)))
        return [cache] * n, [bw] * n, [pf] * n


@dataclasses.dataclass
class StaticGrid:
    """Feasible static configurations, one row per (cache, bw, pf) combo.

    ``cache`` / ``bandwidth`` / ``prefetch`` are ``(C, n)``; ``valid`` is
    ``(C,)`` and is all-True straight out of :func:`enumerate_grid` —
    :meth:`pad_to` appends masked copies of the last row so the scan sees
    a rectangular chunk grid, and the search reductions ignore every
    ``valid == False`` row.
    """

    cache: np.ndarray
    bandwidth: np.ndarray
    prefetch: np.ndarray
    valid: np.ndarray
    total_cache_units: float
    total_bandwidth_gbps: float

    @property
    def n_configs(self) -> int:
        """Feasible (unmasked) configurations."""
        return int(self.valid.sum())

    @property
    def n_apps(self) -> int:
        return int(self.cache.shape[-1])

    def pad_to(self, multiple: int) -> "StaticGrid":
        """Pad rows to a multiple of ``multiple`` with ``valid=False``."""
        c = len(self.valid)
        pad = -(-c // multiple) * multiple - c
        if pad == 0:
            return self

        def ext(a: np.ndarray) -> np.ndarray:
            return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

        return dataclasses.replace(
            self, cache=ext(self.cache), bandwidth=ext(self.bandwidth),
            prefetch=ext(self.prefetch),
            valid=np.concatenate([self.valid, np.zeros(pad, dtype=bool)]))

    def config(self, index) -> Dict[str, np.ndarray]:
        """Allocation arrays for (an array of) config indices.

        Index ``-1`` marks an empty top-k slot (fewer feasible configs
        than ``k``); refusing it here beats numpy's silent wrap-around to
        the last grid row, which would hand the caller an allocation that
        never won anything.
        """
        idx = np.asarray(index)
        if idx.size and (idx < 0).any():
            raise IndexError(
                "config index -1 marks an empty top-k slot (fewer "
                "feasible configurations than k) — no allocation exists "
                "for it")
        return {
            "cache_units": self.cache[idx],
            "bandwidth_gbps": self.bandwidth[idx],
            "prefetch_on": self.prefetch[idx],
        }


def _options_product(opts: Sequence[Tuple[float, ...]]) -> np.ndarray:
    """All per-app combinations, ``itertools.product`` order, ``(K, n)``."""
    grids = np.meshgrid(*[np.asarray(o, np.float64) for o in opts],
                        indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def enumerate_grid(
    cache_options: Sequence[Tuple[float, ...]],
    bw_options: Sequence[Tuple[float, ...]],
    pf_options: Sequence[Tuple[float, ...]],
    *,
    cache_budget: float,
    bw_budget: float,
) -> StaticGrid:
    """Enumerate the feasible static grid for one workload size.

    Each ``*_options`` entry is the option tuple of one application.
    Per-resource combinations whose sum exceeds the budget are dropped
    (sum-feasibility), then the three resources cross — preserving the
    reference enumeration order (cache outermost, then bandwidth, then
    prefetch, last application fastest).
    """
    n = len(cache_options)
    if not (len(bw_options) == n and len(pf_options) == n):
        raise ValueError(
            f"per-app option lists disagree on n: {len(cache_options)}, "
            f"{len(bw_options)}, {len(pf_options)}")
    caches = _options_product(cache_options)
    caches = caches[caches.sum(axis=-1) <= cache_budget + 1e-9]
    bws = _options_product(bw_options)
    bws = bws[bws.sum(axis=-1) <= bw_budget + 1e-9]
    pfs = _options_product(pf_options)
    if len(caches) == 0 or len(bws) == 0:
        violations = []
        for label, opts, budget, combos in (
                ("cache", cache_options, cache_budget, caches),
                ("bandwidth", bw_options, bw_budget, bws)):
            if len(combos) == 0:
                min_sum = (sum(min(o) for o in opts)
                           if all(len(o) for o in opts) else None)
                violations.append(
                    f"{label}: empty per-app option tuple" if min_sum is None
                    else f"{label}: smallest per-app options sum to "
                         f"{min_sum} > budget {budget}")
        raise InfeasibleGridError(
            "no feasible configuration — " + "; ".join(violations))
    cc, cb, cp = len(caches), len(bws), len(pfs)
    return StaticGrid(
        cache=np.repeat(caches, cb * cp, axis=0),
        bandwidth=np.tile(np.repeat(bws, cp, axis=0), (cc, 1)),
        prefetch=np.tile(pfs, (cc * cb, 1)),
        valid=np.ones(cc * cb * cp, dtype=bool),
        total_cache_units=float(cache_budget),
        total_bandwidth_gbps=float(bw_budget),
    )


def family_grid(spec: FamilySpec, n: int,
                options: Optional[StaticOptions] = None) -> StaticGrid:
    """The constrained config grid of one family for ``n``-app workloads."""
    options = options or StaticOptions()
    cache_opts, bw_opts, pf_opts = options.per_app(spec, n)
    return enumerate_grid(
        cache_opts, bw_opts, pf_opts,
        cache_budget=options.cache_budget_per_app * n,
        bw_budget=options.bw_budget_per_app * n)


@dataclasses.dataclass
class StaticSearchResult:
    """Per-(family, workload) best static allocations.

    ``topk_ws`` / ``topk_index`` are ``(W, k)`` numpy arrays (``int64``
    indices) — sorted descending by weighted speedup, distinct config
    indices into ``grids[family]``, with ``-inf`` / ``-1`` filling slots
    beyond the feasible count.  ``backend`` is the type of the device the
    search ran on (``"cuda"`` or ``"cpu"``).

    With ``multi_objective`` the slots hold the Pareto front over
    (weighted speedup, min-fairness) instead of the scalar top-k:
    still sorted descending by weighted speedup — so fairness strictly
    increases down the slots — with ``topk_fairness`` carrying each
    front member's min-fairness and ``k`` doubling as the front
    capacity (fronts wider than ``k`` keep their ``k`` best-ws members).
    """

    family_names: List[str]
    workloads: List[List[str]]
    grids: Dict[str, StaticGrid]
    topk_ws: Dict[str, np.ndarray]
    topk_index: Dict[str, np.ndarray]
    baseline_ipc: np.ndarray            # (W, n)
    backend: str
    k: int
    topk_fairness: Optional[Dict[str, np.ndarray]] = None   # (W, k)
    multi_objective: bool = False

    def knee_index(self, family: str) -> np.ndarray:
        """Per-workload config index of the front's knee point, ``(W,)``.

        The knee is the front member closest (Euclidean) to the utopia
        point after min-max normalizing both objectives over the front —
        the standard balanced-trade-off pick.  Ties and degenerate
        (single-member or zero-span) fronts resolve toward the
        best-weighted-speedup end.  Multi-objective results only.
        """
        if not self.multi_objective:
            raise ValueError(
                "knee_index needs a multi_objective=True search result")
        ws = np.asarray(self.topk_ws[family], dtype=np.float64)
        f = np.asarray(self.topk_fairness[family], dtype=np.float64)
        idx = np.asarray(self.topk_index[family])
        valid = idx >= 0

        def norm(x):
            lo = np.min(np.where(valid, x, np.inf), axis=-1, keepdims=True)
            hi = np.max(np.where(valid, x, -np.inf), axis=-1, keepdims=True)
            span = hi - lo
            return np.where(span > 0, (x - lo) / np.where(span > 0, span, 1.0),
                            1.0)

        dist = (1.0 - norm(ws)) ** 2 + (1.0 - norm(f)) ** 2
        dist = np.where(valid, dist, np.inf)
        pos = np.argmin(dist, axis=-1)       # first minimum: best-ws end
        return np.take_along_axis(idx, pos[:, None], axis=-1)[:, 0]

    @property
    def n_workloads(self) -> int:
        return int(self.baseline_ipc.shape[0])

    def best_ws(self, family: str) -> np.ndarray:
        """Best weighted speedup per workload, shape ``(W,)``."""
        return self.topk_ws[family][:, 0]

    def best_index(self, family: str) -> np.ndarray:
        return self.topk_index[family][:, 0]

    def best_config(self, family: str) -> Dict[str, np.ndarray]:
        """Winning allocation arrays per workload, each ``(W, n)``."""
        return self.grids[family].config(self.best_index(family))

    def geomean(self, family: str) -> float:
        """Geometric-mean best weighted speedup over workloads."""
        return float(np.exp(np.mean(np.log(self.best_ws(family)))))

    def frac_at_least(self, family: str, threshold: float = 1.10) -> float:
        """Fraction of workloads at or above ``threshold`` (Fig. 5b)."""
        return float(np.mean(self.best_ws(family) >= threshold))

    def summary(self) -> Dict[str, float]:
        return {name: round(self.geomean(name), 4)
                for name in self.family_names}


def is_twin(grid: StaticGrid, names: Sequence[str], i: int, j: int) -> bool:
    """Whether configs ``i`` and ``j`` of ``grid`` are the same allocation
    of the same applications: a permutation of application positions that
    maps every application to one of the same name carries config ``i``'s
    cache, bandwidth and prefetch rows onto config ``j``'s.  Decided from
    ``names`` and the grid alone.

    In the partitioned regimes an application's values depend on its own
    allocation only (the banked regime's affinity rows are rotations of
    one vector, so its position orders the bank sum and nothing else):
    twins score the same values in exact arithmetic, and only rounding
    splits them.
    """
    if i == j:
        return True
    if i < 0 or j < 0:
        return False
    rows = [np.stack([grid.cache[c], grid.bandwidth[c], grid.prefetch[c]],
                     axis=-1) for c in (i, j)]
    for name in set(names):
        pos = [a for a, other in enumerate(names) if other == name]
        if (sorted(map(tuple, rows[0][pos].tolist()))
                != sorted(map(tuple, rows[1][pos].tolist()))):
            return False
    return True


def _resolve_families(
    families: Optional[Mapping[str, Union[FamilySpec, Mapping[str, bool]]]],
) -> Dict[str, FamilySpec]:
    if families is None:
        return dict(FIG5_FAMILIES)
    out: Dict[str, FamilySpec] = {}
    for name, spec in families.items():
        out[name] = spec if isinstance(spec, FamilySpec) else FamilySpec(**spec)
    if not out:
        raise ValueError("families must be non-empty")
    return out


def _pareto_topk(ws: np.ndarray, fairness: np.ndarray, index: np.ndarray,
                 k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``k`` best-ws Pareto-front members of one candidate set (the
    plain version of the Pareto fold of :func:`_family_scan`).

    Sort by (ws desc, fairness desc, index asc); an entry is on the front
    iff its fairness strictly exceeds the exclusive running max — which
    drops strictly dominated entries, weakly dominated ones (equal in one
    objective, worse in the other) and exact duplicates (keeping the
    lowest index) in one rule.  Masked candidates carry ``-inf`` in both
    objectives and can never be kept.
    """
    order = np.lexsort((index, -fairness, -ws))
    s_ws, s_f, s_idx = ws[order], fairness[order], index[order]
    run_max = np.concatenate(
        [[-np.inf], np.maximum.accumulate(s_f)[:-1]])
    kept_ws = np.where(s_f > run_max, s_ws, -np.inf)
    sel = np.argsort(-kept_ws, kind="stable")[:k]
    out_ws, out_f, out_idx = kept_ws[sel], s_f[sel], s_idx[sel]
    empty = np.isinf(out_ws)
    pad = k - len(sel)
    return (np.concatenate([out_ws, np.full(pad, -np.inf)]),
            np.concatenate([np.where(empty, -np.inf, out_f),
                            np.full(pad, -np.inf)]),
            np.concatenate([np.where(empty, -1, out_idx),
                            np.full(pad, -1, out_idx.dtype)]))


# --------------------------------------------------------------------- #
# the device layer
# --------------------------------------------------------------------- #

def _family_tables(grid: StaticGrid, w_pad: int, k: int,
                   chunk_elements: int) -> Dict[str, np.ndarray]:
    """Chunk one family's config grid into the scan tables it runs over.

    The reference's chunk rule, with ``w_pad`` the padded global workload
    count (the workload count on one device; under sharding every block
    gets the same global value, not its own count): the chunk shape
    depends only on this family's grid, so the stacked, per-family and
    sharded searches scan the same tables, and ties across chunks resolve
    as in the reference.
    """
    n = grid.n_apps
    chunk = max(k, min(len(grid.valid),
                       max(1, chunk_elements // max(1, w_pad * n))))
    padded = grid.pad_to(chunk)
    s = len(padded.valid) // chunk
    return {
        "cache": padded.cache.reshape(s, chunk, n),
        "bandwidth": padded.bandwidth.reshape(s, chunk, n),
        "prefetch": padded.prefetch.reshape(s, chunk, n),
        "valid": padded.valid.reshape(s, chunk),
        "index": np.arange(s * chunk, dtype=np.int64).reshape(s, chunk),
    }


def _scores(p, base: torch.Tensor, grid: StaticGrid, cache, bw, pf,
            valid: torch.Tensor, iters: int, banks: int, multi: bool):
    """Weighted speedup, and with ``multi`` the min-fairness, of every
    (workload, config) pair of one block of configs: ``(W, C)`` each,
    ``-inf`` on masked configs.

    ``p`` holds the model fields as ``(W, 1, n)`` tensors, ``base`` the
    baseline IPC ``(W, n)``, ``cache`` / ``bw`` / ``pf`` ``(C, n)`` and
    ``valid`` ``(C,)`` tensors on the same device.  The mean over
    applications is :func:`numpy_order_sum` divided by ``n``, a tensor
    (the card turns a division by a host scalar into a multiplication by
    its reciprocal).
    """
    ss = memsys.evaluate(
        p, cache, bw, pf, total_cache_units=grid.total_cache_units,
        total_bandwidth_gbps=grid.total_bandwidth_gbps,
        bandwidth_banks=banks, iters=iters)
    speedup = ss.ipc / base[:, None, :]                  # (W, C, n)
    n = torch.full((), float(speedup.shape[-1]), dtype=F64,
                   device=speedup.device)
    ws = torch.where(valid, numpy_order_sum(speedup)[..., 0] / n, -torch.inf)
    if not multi:
        return ws, None
    fair = torch.amin(speedup, dim=-1) / torch.amax(speedup, dim=-1)
    return ws, torch.where(valid, fair, -torch.inf)


def _stable_topk(values: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, equal values in position
    order: ``(values, positions)``."""
    out, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return out[..., :k], pos[..., :k]


def _stable_order(values: torch.Tensor, order: torch.Tensor,
                  descending: bool) -> torch.Tensor:
    """Reorder ``order`` by ``values`` taken in that order, stably."""
    key = torch.gather(values, -1, order)
    return torch.gather(order, -1, torch.sort(
        key, dim=-1, descending=descending, stable=True).indices)


def _family_scan(p, base: torch.Tensor, grid: StaticGrid,
                 tables: Dict[str, np.ndarray], k: int, iters: int,
                 banks: int = 1, multi: bool = False):
    """The chunked top-k fold of ONE family: ``(top_ws, top_idx, top_f)``
    as ``(W, k)`` tensors on ``base``'s device (``top_f`` is ``None``
    without ``multi``).

    Each step scores one chunk (:func:`_scores`) and merges the running
    entries, first, with the chunk's under a stable descending sort, so
    the lowest enumeration index wins a tie.  With ``multi`` the carry is
    the Pareto front over (weighted speedup, min-fairness): each step
    merges the running front with the WHOLE chunk under the
    :func:`_pareto_topk` keep rule and keeps the ``k`` best-ws survivors.
    """
    dev = base.device
    w = base.shape[0]
    tabs = {key: torch.as_tensor(v, device=dev) for key, v in tables.items()}
    top_ws = torch.full((w, k), -torch.inf, dtype=F64, device=dev)
    top_idx = torch.full((w, k), -1, dtype=torch.int64, device=dev)
    top_f = torch.full((w, k), -torch.inf, dtype=F64, device=dev)
    for c_cache, c_bw, c_pf, c_valid, c_idx in zip(
            tabs["cache"], tabs["bandwidth"], tabs["prefetch"],
            tabs["valid"], tabs["index"]):
        ws, fair = _scores(p, base, grid, c_cache, c_bw, c_pf, c_valid,
                           iters, banks, multi)
        if not multi:
            cand_ws, cand_loc = _stable_topk(ws, k)
            merged_ws = torch.cat([top_ws, cand_ws], dim=-1)
            merged_idx = torch.cat([top_idx, c_idx[cand_loc]], dim=-1)
            top_ws, sel = _stable_topk(merged_ws, k)
            top_idx = torch.gather(merged_idx, -1, sel)
            continue
        m_ws = torch.cat([top_ws, ws], dim=-1)
        m_f = torch.cat([top_f, fair], dim=-1)
        m_idx = torch.cat([top_idx, c_idx.expand(w, -1)], dim=-1)
        # _pareto_topk's lexsort((idx, -f, -ws)) as three stable sorts,
        # the least significant key first.
        order = torch.sort(m_idx, dim=-1, stable=True).indices
        order = _stable_order(m_f, order, descending=True)
        order = _stable_order(m_ws, order, descending=True)
        s_ws = torch.gather(m_ws, -1, order)
        s_f = torch.gather(m_f, -1, order)
        s_idx = torch.gather(m_idx, -1, order)
        run_max = torch.cat(
            [torch.full((w, 1), -torch.inf, dtype=F64, device=dev),
             torch.cummax(s_f, dim=-1).values[:, :-1]], dim=-1)
        kept_ws = torch.where(s_f > run_max, s_ws, -torch.inf)
        top_ws, sel = _stable_topk(kept_ws, k)
        empty = torch.isinf(top_ws)
        top_f = torch.where(empty, -torch.inf, torch.gather(s_f, -1, sel))
        top_idx = torch.where(empty, -1, torch.gather(s_idx, -1, sel))
    return top_ws, top_idx, (top_f if multi else None)


def _model_inputs(stacked: AppArrays, options: StaticOptions, iters: int,
                  dev: torch.device):
    """The model fields as ``(W, 1, n)`` tensors on ``dev`` and the shared
    equal-share baseline IPC ``(W, n)``: both regimes partitioned at the
    budgets' equal shares, prefetch off."""
    n = stacked.n
    total_units = options.cache_budget_per_app * n
    total_bw = options.bw_budget_per_app * n
    units_eq, bw_eq = equal_share(n, total_units, total_bw)
    params = from_numpy(app_fields(stacked), dev)              # (W, n)
    base = memsys.evaluate(
        params, units_eq.astype(np.float64), bw_eq, np.zeros(n),
        total_cache_units=total_units, total_bandwidth_gbps=total_bw,
        iters=iters).ipc
    return {f: v[:, None, :] for f, v in params.items()}, base


def _grid_scores(workloads: Sequence[Sequence[str]], grid: StaticGrid,
                 banks: int = 1, device: DeviceLike = None,
                 options: Optional[StaticOptions] = None,
                 iters: int = FIG5_ITERS) -> torch.Tensor:
    """The weighted speedups the search ranks, ``(W, C)``, for the whole
    of ``grid`` in one evaluation (no chunks): what a check of the
    chunked selection sorts."""
    dev = resolve_device(device)
    p, base = _model_inputs(stack_mixes([list(w) for w in workloads]),
                            options or StaticOptions(), iters, dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return _scores(p, base, grid, t(grid.cache), t(grid.bandwidth),
                   t(grid.prefetch), t(grid.valid), iters, banks, False)[0]


def _to_host(top) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    top_ws, top_idx, top_f = top
    return (top_ws.cpu().numpy(), top_idx.cpu().numpy(),
            None if top_f is None else top_f.cpu().numpy())


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #

def search_static(
    workloads: Union[Sequence[Sequence[str]], AppArrays],
    families: Optional[Mapping[str, Union[FamilySpec, Mapping]]] = None,
    *,
    k: int = 1,
    device: DeviceLike = None,
    options: Optional[StaticOptions] = None,
    iters: int = FIG5_ITERS,
    chunk_elements: int = CHUNK_ELEMENTS,
    stack_families: bool = True,
    multi_objective: bool = False,
    shard: Optional[bool] = None,
) -> StaticSearchResult:
    """Best static (cache, bandwidth, prefetch) allocation per workload.

    Args:
      workloads: equal-size workloads — lists of app names (any n, not
        just the paper's 4) or an already-stacked ``(W, n)`` AppArrays.
      families: name -> :class:`FamilySpec` (or kwargs dict); default the
        paper's :data:`FIG5_FAMILIES`.
      k: how many best configs to return per workload (sorted, distinct).
      device: ``None`` is the CUDA card (raises without one); pass
        ``"cpu"`` to run on the CPU.
      options: the option grid / budgets (:class:`StaticOptions`).
      iters: fixed-point iterations (Fig. 5 protocol default 40).
      chunk_elements: scan chunk budget (W x chunk x n).
      stack_families: scan every family back to back and copy all the
        results to the host at once (the default); ``False`` copies each
        family's result as its scan ends — the stacking parity
        reference, bit-identical per family.
      multi_objective: fold the Pareto front over (weighted speedup,
        min-fairness) instead of the scalar top-k — ``topk_*`` then hold
        the front's ``k`` best-ws members (ws descending, fairness
        ascending down the slots) and ``topk_fairness`` is populated;
        ``k`` doubles as the front capacity.  Min-fairness is
        ``min(speedup) / max(speedup)`` per workload.
      shard: ``None`` shards the workload axis over the devices of
        :func:`repro_torch.distributed.device_list`
        (:func:`~repro_torch.distributed.row_shard_count`, padded with
        copies of the last workload); ``False`` runs on ``device`` alone.
        Every block scans the chunks of the padded global workload count,
        as the reference's sharded search does, and the one baseline
        evaluation is shared.

    Returns:
      :class:`StaticSearchResult` of numpy arrays; weighted speedups are
      against the equal-share static partitioned baseline (prefetch off),
      the ``_exhaustive_best`` normalization.
    """
    dev = resolve_device(device)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    fams = _resolve_families(families)
    options = options or StaticOptions()

    stacked = (workloads if isinstance(workloads, AppArrays)
               else stack_mixes([list(w) for w in workloads]))
    shape = np.asarray(stacked.cpi_base).shape
    if len(shape) != 2 or shape[0] == 0:
        raise ValueError(
            f"workloads must stack to a non-empty (W, n); got {shape}")
    w, n = shape
    names = [list(m) for m in stacked.names] if stacked.names else []

    grids = {}
    for name, spec in fams.items():
        try:
            grid = family_grid(spec, n, options)
        except InfeasibleGridError as exc:
            raise InfeasibleGridError(f"family {name!r}: {exc}") from None
        if grid.n_configs == 0:
            raise InfeasibleGridError(
                f"family {name!r} has zero feasible configurations")
        grids[name] = grid
    p, base = _model_inputs(stacked, options, iters, dev)
    n_shards = 1 if shard is False else distributed.row_shard_count(w, dev)
    w_pad = -(-w // n_shards) * n_shards
    tables = {name: _family_tables(grid, w_pad, k, chunk_elements)
              for name, grid in grids.items()}

    def scan_block(p_b, base_b, names):
        return {name: _family_scan(
            p_b, base_b, grids[name], tables[name], k, iters,
            int(fams[name].bandwidth_banks), multi_objective)
            for name in names}

    def scan(names):
        """``names``' top-k as ``(W, k)`` tensors on ``dev``."""
        if n_shards == 1:
            return scan_block(p, base, names)
        pad = {key: torch.cat([v, v[-1:].expand(w_pad - w, *v.shape[1:])])
               for key, v in {**p, "baseline": base}.items()}

        def worker(block, _replicated):
            tops = scan_block({f: block[f] for f in p}, block["baseline"],
                              names)
            return {name: {key: t for key, t in zip(("ws", "idx", "f"), top)
                           if t is not None}
                    for name, top in tops.items()}

        out = distributed.shard_rows(worker, n_shards, dev)(pad, {})
        return {name: (o["ws"][:w], o["idx"][:w],
                       o["f"][:w] if "f" in o else None)
                for name, o in out.items()}

    if stack_families:
        tops = scan(list(grids))
        host = [torch.stack(part).cpu().numpy() if part[0] is not None
                else part for part in zip(*tops.values())]
        out = {name: tuple(h[fi] for h in host)
               for fi, name in enumerate(grids)}
    else:
        out = {name: _to_host(scan([name])[name]) for name in grids}

    return StaticSearchResult(
        family_names=list(fams),
        workloads=names,
        grids=grids,
        topk_ws={name: o[0] for name, o in out.items()},
        topk_index={name: o[1] for name, o in out.items()},
        baseline_ipc=base.cpu().numpy(),
        backend=dev.type,
        k=k,
        topk_fairness=({name: o[2] for name, o in out.items()}
                       if multi_objective else None),
        multi_objective=multi_objective,
    )
