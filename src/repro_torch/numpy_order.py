"""Sums in numpy's rounding order on tensors.

``torch.sum`` accumulates in another order than numpy's ``pairwise_sum``
(and in another one again on the card), so a sum that decides a
comparison or feeds a bit-parity contract lands an ulp off the numpy
golden.  :func:`numpy_order_sum` unrolls numpy's add tree in Python;
Algorithm 1's delay total (:mod:`repro_torch.runtime.plant`) and the
static search's mean over applications
(:mod:`repro_torch.sim.static_search`) use it.
"""
from __future__ import annotations

import torch


def numpy_order_sum(vec: torch.Tensor) -> torch.Tensor:
    """Sum ``(..., m)`` over the last axis in numpy's rounding order ->
    ``(..., 1)``.

    ``m`` is static, so the add tree unrolls in Python, as numpy's: sequential under 8 elements; eight accumulators (one
    8-lane add per block here) up to 128, folded as ``((r0 + r1) + (r2 +
    r3)) + ((r4 + r5) + (r6 + r7))`` and then the tail; recursive halving
    on a multiple of 8 beyond.
    """
    return _psum(vec, 0, vec.shape[-1])


def _psum(vec: torch.Tensor, lo: int, m: int) -> torch.Tensor:
    """``vec[..., lo:lo + m]`` summed in numpy's order.  A module function,
    not a closure: a nested function that calls itself holds its own cell,
    a reference cycle that would keep ``vec`` until a collector pass."""
    if m < 8:
        acc = vec[..., lo:lo + 1]
        for i in range(lo + 1, lo + m):
            acc = acc + vec[..., i:i + 1]
        return acc
    if m <= 128:
        r = vec[..., lo:lo + 8]
        i = 8
        while i < m - (m % 8):
            r = r + vec[..., lo + i:lo + i + 8]
            i += 8
        while r.shape[-1] > 1:        # the pairwise fold of the lanes
            r = r[..., 0::2] + r[..., 1::2]
        for k in range(lo + i, lo + m):
            r = r + vec[..., k:k + 1]
        return r
    m2 = (m // 2) - ((m // 2) % 8)
    return _psum(vec, lo, m2) + _psum(vec, lo + m2, m - m2)
