"""Deterministic synthetic training-plant model (counterpart of
:mod:`repro.train.plant_model`).

The fused schedule (:mod:`repro_torch.runtime.plant`) and the host
golden (``CBPCoordinator`` over ``TrainingPlant``) run the same step
model: the rates are written once (:func:`_stream_rates`) over torch
tensors on any device, and every data-dependent constant is drawn with
numpy's ``default_rng(seed)`` in the reference's order, so the same seed
gives the reference's plant bit for bit.

The reference pins every rounding point (``pin_f64``) because XLA's CPU
backend contracts multiply-adds into FMAs.  Here ``pin`` is the identity:
eager PyTorch runs each op as its own kernel and rounds its result to
float64 in memory, so no product and sum can contract, on the CPU or on
the card.  Nothing on this path is compiled with ``torch.compile``, which
could fuse them.  Division is always by a tensor: PyTorch's CUDA
true-divide by a CPU scalar multiplies by the reciprocal instead, so the
totals enter as precomputed reciprocals, as in the reference.

The model is a stylized training job with ``n`` memory-system streams
(input pipeline, checkpoint writer, compute streams): throughput rises
with staging-buffer share and bandwidth share; prefetching helps
bandwidth-rich streams and pollutes buffer-poor ones (so the A/B throttle
has a real decision to make); queue wait falls with bandwidth; and the
buffer utility curves are per-stream concave profiles whose height tracks
the prefetch setting (interaction #5).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import F64, DeviceLike, resolve_device


def plant_constants(n_clients: int, total_units: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The plant's float64 constants, drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    units_axis = np.arange(total_units + 1, dtype=np.float64)
    knee = rng.uniform(0.08, 0.45, n_clients) * total_units
    c = {
        "base": rng.uniform(0.6, 1.4, n_clients),
        "cache_gain": rng.uniform(0.2, 1.0, n_clients),
        "bw_gain": rng.uniform(0.5, 2.0, n_clients),
        "pf_gain": rng.uniform(0.0, 0.35, n_clients),
        "pf_pollution": rng.uniform(0.0, 0.12, n_clients),
        "pf_wait": rng.uniform(-0.2, 0.3, n_clients),
        "pf_flatten": rng.uniform(-0.3, 0.1, n_clients),
        "wait_base": rng.uniform(20.0, 120.0, n_clients),
        "curve_amp": rng.uniform(50.0, 400.0, n_clients),
        # concave hits-vs-units profiles (saturating rational, precomputed
        # so the curve's shape costs no per-step arithmetic)
        "curve": units_axis[None, :] / (units_axis[None, :] + knee[:, None]),
    }
    return {k: np.asarray(v, dtype=np.float64) for k, v in c.items()}


def _stream_rates(c: Dict[str, torch.Tensor], units, bandwidth, prefetch,
                  total_units: int, total_bandwidth: float):
    """The shared arithmetic: elementwise float64, the reference's op
    sequence.  ``units`` and ``prefetch`` arrive as float64."""
    # Multiply by the reciprocal taken in Python, as the reference does.
    u = units * (1.0 / total_units)
    b = bandwidth * (1.0 / total_bandwidth)
    pollute = c["pf_pollution"] / (0.25 + u)
    thr = ((c["base"] * (1.0 + c["cache_gain"] * u))
           * (1.0 + c["bw_gain"] * b)) \
        * (1.0 + prefetch * (c["pf_gain"] - pollute))
    wait = (c["wait_base"] / (b + 0.125)) * (1.0 + c["pf_wait"] * prefetch)
    scale = 1.0 + c["pf_flatten"] * prefetch
    curves = (c["curve_amp"] * scale)[:, None] * c["curve"]
    return thr, wait, curves


def make_stream_plant_model(
    n_clients: int,
    total_units: int,
    total_bandwidth: float,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[Callable, Callable]:
    """Build the (``step_fn``, ``step_model``) pair over one set of
    constants on ``device`` (``None``: the card).

    ``step_fn(duration_ms, knobs)`` takes a
    :class:`~repro_torch.runtime.cbp_runtime.StreamKnobs` and is
    ``TrainingPlant``'s step; ``step_model(duration_ms, units_f64,
    bandwidth, prefetch_f64)`` is the fused schedule's.  Both return
    ``(throughput (n,), queue_wait_ms (n,), utility_curves (n, U+1))``
    float64 tensors on ``device``.
    """
    dev = resolve_device(device)
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in plant_constants(n_clients, total_units, seed).items()}

    def step_model(duration_ms, units, bandwidth, prefetch):
        return _stream_rates(c, units, bandwidth, prefetch, total_units,
                             total_bandwidth)

    def step_fn(duration_ms: float, knobs):
        return _stream_rates(
            c, torch.as_tensor(knobs.buffer_units, device=dev).to(F64),
            torch.as_tensor(knobs.bandwidth_mbps, dtype=F64, device=dev),
            torch.as_tensor(knobs.prefetch_on, device=dev).to(F64),
            total_units, total_bandwidth)

    return step_fn, step_model
