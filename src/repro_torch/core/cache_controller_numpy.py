"""UCP Lookahead on the host, in numpy (copy of the golden reference
:func:`repro.core.cache_controller.lookahead_allocate` / ``cppf_allocate``).

This is the ``"numpy"`` backend of
:class:`repro_torch.core.cache_controller.CacheController`, chosen
explicitly (``CMPConfig(allocator_backend="numpy")``), never as a
fallback.  Tie-breaks, shared with the device greedy: among clients with
equal best marginal utility the lowest index wins; within a client the
smallest step wins; the zero-utility spread orders clients by remaining
potential gain with a stable sort.

:func:`lookahead_allocate` counts its calls (:func:`allocator_calls`), so
a test can show that a device-resident run makes none.
"""
from __future__ import annotations

import numpy as np

#: Number of times :func:`lookahead_allocate` has run in this process.
_ALLOCATOR_CALLS = 0


def allocator_calls() -> int:
    """Total numpy ``lookahead_allocate`` invocations so far."""
    return _ALLOCATOR_CALLS


def reset_allocator_calls() -> None:
    global _ALLOCATOR_CALLS
    _ALLOCATOR_CALLS = 0


def _max_marginal_utility(curve: np.ndarray, have: int, balance: int):
    """Lookahead's get_max_mu: the best ``(mu, k)`` step from ``have``,
    ``k`` maximizing ``(curve[have + k] - curve[have]) / k`` over
    ``1 <= k <= balance``."""
    top = min(have + balance, len(curve) - 1)
    if top <= have:
        return 0.0, 0
    ks = np.arange(1, top - have + 1)
    gains = curve[have + 1: top + 1] - curve[have]
    mus = gains / ks
    best = int(np.argmax(mus))
    return float(mus[best]), int(ks[best])


def lookahead_allocate(
    utility_curves: np.ndarray,
    total_units: int,
    min_units: int = 4,
) -> np.ndarray:
    """Allocate ``total_units`` among clients by greedy marginal utility.

    ``utility_curves`` is ``(n, total_units + 1)``: hits of client ``i``
    with ``u`` units.  Returns an ``(n,)`` int64 allocation, each client at
    least ``min_units``, summing exactly to ``total_units``.
    """
    global _ALLOCATOR_CALLS
    _ALLOCATOR_CALLS += 1
    curves = np.asarray(utility_curves, dtype=np.float64)
    n = curves.shape[0]
    if curves.shape[1] != total_units + 1:
        raise ValueError(
            f"utility curves must have {total_units + 1} points, "
            f"got {curves.shape[1]}")
    if n * min_units > total_units:
        raise ValueError("min_units * n exceeds capacity")

    alloc = np.full(n, min_units, dtype=np.int64)
    balance = total_units - int(alloc.sum())

    while balance > 0:
        best_mu = -1.0
        best_i = -1
        best_k = 0
        for i in range(n):
            mu, k = _max_marginal_utility(curves[i], int(alloc[i]), balance)
            if k > 0 and mu > best_mu:
                best_mu, best_i, best_k = mu, i, k
        if best_i < 0 or best_mu <= 0.0:
            # No client gains from more cache: spread the remainder (UCP
            # leaves no capacity idle), by remaining gain, stable.
            order = np.argsort(
                -(curves[:, -1] - curves[np.arange(n), alloc]),
                kind="stable")
            j = 0
            while balance > 0:
                i = int(order[j % n])
                if alloc[i] < total_units:
                    alloc[i] += 1
                    balance -= 1
                j += 1
            break
        alloc[best_i] += best_k
        balance -= best_k

    if int(alloc.sum()) != total_units:
        raise RuntimeError("Lookahead allocation does not sum to capacity")
    return alloc


def cppf_allocate(
    utility_curves: np.ndarray,
    total_units: int,
    min_units: int,
    active: np.ndarray,
) -> np.ndarray:
    """CPpf allocation (paper §4.4): inactive clients pinned at
    ``min_units``, UCP over the remaining capacity for the active ones;
    with no active client an even split, remainder to the lowest
    indices."""
    curves = np.asarray(utility_curves, dtype=np.float64)
    active = np.asarray(active, dtype=bool)
    n = curves.shape[0]
    units = np.full(n, min_units, dtype=np.int64)
    others = np.where(active)[0]
    remaining = total_units - min_units * int((~active).sum())
    if len(others) > 0:
        units[others] = lookahead_allocate(
            curves[others][:, : remaining + 1], remaining, min_units)
    else:
        extra = total_units - n * min_units
        units += extra // n
        units[: extra % n] += 1
    if int(units.sum()) != total_units:
        raise RuntimeError("CPpf allocation does not sum to capacity")
    return units
