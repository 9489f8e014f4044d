"""The CMP interval model on tensors (counterpart of
:mod:`repro.sim.memsys_jax`; the numpy model :mod:`repro.sim.memsys` is
the golden both are held to).

Same math, same constants and the same 60-iteration damped fixed point as
the reference, written as plain functions on float64 tensors.  All
arguments broadcast against ``(..., n)``, so a leading (manager * mix)
row axis batches the whole solve; the stacked timeline
(:mod:`repro_torch.sim.timeline`) runs it on ``(B, n)`` rows.

Contract (``tests/test_torch_memsys.py``): within rtol 1e-9 of
``memsys_jax`` run in float64, and within 1e-5 of the numpy golden.  The
gap to ``memsys_jax`` is op order and the ``exp``/``pow`` implementations
of each backend, not precision.  Toward the numpy golden the model pins
what it can: every division is by a tensor, the bank powers come from
numpy and the bank sums run in numpy's order, so on the CPU the static
search's scores equal the golden's bit for bit, and on the card only
``exp`` is another implementation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import F64, as_f64
from repro_torch.numpy_order import numpy_order_sum
from repro_torch.sim.apps import MODEL_FIELDS

# Constants of the interval model (copied from repro.sim.memsys).
FREQ_GHZ = 4.0            # paper Table 1: 4 GHz cores
DRAM_LAT_NS = 80.0        # paper Table 1: 80 ns memory latency
LINE_BYTES = 64.0
Q_SCALE_NS = 42.0         # queuing-delay scale (calibrated)
IF_SKEW = 0.8             # shared-queue unfairness (FR-FCFS-like skew)
PF_QUEUE_WEIGHT = 0.55    # prefetch fills barely lengthen the demand queue
RHO_MAX = 0.98            # queue stability clip
FIXED_POINT_ITERS = 60
DAMPING = 0.5
BANK_SKEW = 0.6           # banked-token mode: per-bank access affinity decay
DEFAULT_BANDWIDTH_BANKS = 4

#: AppArrays fields the model consumes.
PARAM_FIELDS = MODEL_FIELDS

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class SteadyState:
    """Model outputs for a batch of (workload, allocation) evaluations."""

    ipc: torch.Tensor            # (..., n)
    queuing_delay_ns: torch.Tensor
    traffic_gbps: torch.Tensor
    mpki: torch.Tensor           # effective demand MPKI
    exposed_mpki: torch.Tensor   # misses whose latency the core eats
    occupancy_units: torch.Tensor  # effective cache units used


def mpki_curve(params: Params, units: torch.Tensor) -> torch.Tensor:
    """Miss curve: MPKI as a function of (real-valued) allocated units."""
    u = torch.clamp(units, min=1.0)
    span = params["mpki_min_alloc"] - params["mpki_floor"]
    return params["mpki_floor"] + span * torch.exp(
        -(u - 4.0) / params["ws_units"])


def _bank_affinity(n_apps: int, n_banks: int,
                   device: torch.device) -> torch.Tensor:
    """Per-(client, bank) access affinity (static bank count)."""
    i = torch.arange(n_apps, dtype=F64, device=device)[:, None]
    b = torch.arange(n_banks, dtype=F64, device=device)[None, :]
    a = torch.pow(BANK_SKEW, torch.remainder(i + b, float(n_banks)))
    return a / a.sum(dim=-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _skew_powers(max_banks: int, device: torch.device) -> torch.Tensor:
    """``BANK_SKEW ** k`` for ``k < max_banks``, computed by numpy (the
    golden's ``pow``) and kept on ``device``."""
    return torch.as_tensor(
        np.power(BANK_SKEW, np.arange(max_banks, dtype=np.float64)),
        device=device)


def _bank_weights(shape, banks: torch.Tensor, max_banks: int,
                  device: torch.device):
    """The banked regime's per-(row, client, bank) affinity for a
    per-row bank count: ``(nb, active, aff)``, with ``nb`` the bank count
    ``(..., n, 1)``, ``active`` the banks below it and ``aff`` the
    normalised affinity ``(..., n, max_banks)``, zero on masked banks.

    Every affinity row is a rotation of one vector, so two copies of an
    application that swap allocations tie in exact arithmetic: the powers
    come from numpy and the sum runs in numpy's order, so that only the
    golden's own rounding splits such a tie.
    """
    n = shape[-1]
    i = torch.arange(n, dtype=F64, device=device)[:, None]          # (n, 1)
    b = torch.arange(max_banks, dtype=F64, device=device)[None, :]  # (1, MAXB)
    nb = torch.broadcast_to(banks, shape)[..., None]                # (..., n, 1)
    active = b < nb
    a_raw = torch.where(
        active, _skew_powers(max_banks, device)[
            torch.remainder(i + b, nb).long()], 0.0)
    return nb, active, a_raw / numpy_order_sum(a_raw)


def _banked_queueing(traffic_q: torch.Tensor, bw: torch.Tensor, weights):
    """Affinity-weighted per-bank queueing (``weights`` from
    :func:`_bank_weights`), the bank sum in numpy's order.

    Rows with one bank reduce exactly to the flat partitioned channel
    model: the affinity is 1.0, masked banks add exact zeros to the queue
    sum and ``+inf`` to the cap min.  Returns ``(q_ns, cap_gbps)``.
    """
    nb, active, aff = weights
    bank_bw = bw[..., None] / nb
    rho_b = traffic_q[..., None] * aff / torch.clamp(bank_bw, min=1e-6)
    rho_cb = torch.clamp(rho_b, 0.0, RHO_MAX)
    q_bank = Q_SCALE_NS * rho_cb / (1.0 - rho_cb)
    q_ns = numpy_order_sum(aff * q_bank)[..., 0]
    cap = torch.amin(
        torch.where(active, bank_bw / torch.where(active, aff, 1.0),
                    torch.inf),
        dim=-1)
    return q_ns, cap


def _evaluate_rowflags(
    params: Params,
    cache_units: torch.Tensor,
    bw: torch.Tensor,
    pf: torch.Tensor,
    total_cache_units: float,
    total_bandwidth_gbps: float,
    llc_extra_cycles: float,
    cache_partitioned: torch.Tensor,
    bandwidth_partitioned: torch.Tensor,
    iters: int,
    bandwidth_banks: Optional[torch.Tensor] = None,
    max_banks: int = 1,
):
    """The fixed point with per-row partitioning flags.

    ``cache_partitioned`` / ``bandwidth_partitioned`` are boolean tensors
    broadcasting against the batch axes; both branches of each regime are
    computed and selected elementwise, as in the reference.  ``max_banks >
    1`` routes every partitioned row through the banked formula, whose
    1-bank rows equal the flat model.  Returns ``(ipc, q_ns, traffic,
    mpki, exposed, occupancy)``.
    """
    shape = torch.broadcast_shapes(
        cache_units.shape, bw.shape, pf.shape, params["cpi_base"].shape)
    n = shape[-1]
    ipc = torch.broadcast_to(1.0 / params["cpi_base"], shape)
    zeros = torch.zeros(shape, dtype=F64, device=ipc.device)
    q_ns, traffic, mpki_eff, exposed, occ = zeros, zeros, zeros, zeros, zeros
    cache_part = torch.broadcast_to(cache_partitioned, shape)
    bw_part = torch.broadcast_to(bandwidth_partitioned, shape)
    occ_p = torch.broadcast_to(cache_units, shape).to(F64)
    if max_banks > 1:
        weights = _bank_weights(shape, bandwidth_banks, max_banks,
                                ipc.device)
    # A tensor divisor: the card turns a division by a host scalar into a
    # product with its reciprocal, which is not the golden's division.
    thousand = torch.full((), 1000.0, dtype=F64, device=ipc.device)

    for _ in range(iters):
        # ---- cache occupancy ------------------------------------------ #
        miss_rate = torch.clamp(mpki_eff, min=1e-3) * ipc
        share = miss_rate / torch.sum(miss_rate, dim=-1, keepdim=True)
        occ = torch.where(cache_part, occ_p, share * total_cache_units)
        occ_eff = torch.clamp(occ - params["pf_pollution"] * pf, min=1.0)

        # ---- prefetch-adjusted miss stream ---------------------------- #
        m = mpki_curve(params, occ_eff)
        covered = params["pf_cov"] * pf * m
        exposed = m - covered * params["pf_hide"]
        useless = covered * (
            1.0 / torch.clamp(params["pf_acc"], min=1e-3) - 1.0)
        reqki = m * (1.0 + params["wb_frac"]) + useless
        reqki_q = ((m - covered) + m * params["wb_frac"]
                   + PF_QUEUE_WEIGHT * (covered + useless))

        # ---- memory queuing ------------------------------------------- #
        traffic = ipc * FREQ_GHZ * reqki * LINE_BYTES / thousand
        traffic_q = ipc * FREQ_GHZ * reqki_q * LINE_BYTES / thousand
        if max_banks > 1:
            q_p, cap_p = _banked_queueing(traffic_q, bw, weights)
            cap_p = torch.broadcast_to(cap_p, shape)
        else:
            rho_p = traffic_q / torch.clamp(bw, min=1e-6)
            rho_cp = torch.clamp(rho_p, 0.0, RHO_MAX)
            q_p = Q_SCALE_NS * rho_cp / (1.0 - rho_cp)
            cap_p = torch.broadcast_to(bw, shape)
        tot = torch.sum(traffic_q, dim=-1, keepdim=True)
        rho_u = torch.broadcast_to(tot / total_bandwidth_gbps, shape)
        tot_full = torch.sum(traffic, dim=-1, keepdim=True)
        safe_tot = torch.where(tot_full > 0, tot_full, 1.0)
        frac = torch.where(tot_full > 0, traffic / safe_tot, 1.0 / n)
        rho_cu = torch.clamp(rho_u, 0.0, RHO_MAX)
        q_u = Q_SCALE_NS * rho_cu / (1.0 - rho_cu)
        q_u = q_u * (1.0 + IF_SKEW * (1.0 - frac))
        cap_gbps = torch.where(bw_part, cap_p, frac * total_bandwidth_gbps)
        q_ns = torch.where(bw_part, q_p, q_u)

        # ---- IPC ------------------------------------------------------ #
        penalty_cyc = (DRAM_LAT_NS + q_ns) * FREQ_GHZ / params["mlp"]
        cpi = (params["cpi_base"]
               + params["apki"] / thousand * llc_extra_cycles
               + exposed / thousand * penalty_cyc)
        ipc_demand = 1.0 / cpi
        ipc_cap = RHO_MAX * cap_gbps / torch.clamp(
            FREQ_GHZ * reqki * LINE_BYTES / thousand, min=1e-9)
        ipc_new = torch.minimum(ipc_demand, ipc_cap)
        ipc = DAMPING * ipc + (1.0 - DAMPING) * ipc_new
        mpki_eff = m
    return ipc, q_ns, traffic, mpki_eff, exposed, occ


def evaluate(
    params: Params,
    cache_units,
    bandwidth_gbps,
    prefetch_on,
    *,
    cache_partitioned: bool = True,
    bandwidth_partitioned: bool = True,
    total_cache_units: float = 256.0,
    total_bandwidth_gbps: float = 64.0,
    llc_extra_cycles: float = 0.0,
    bandwidth_banks: int = 1,
    iters: int = FIXED_POINT_ITERS,
) -> SteadyState:
    """Counterpart of :func:`repro.sim.memsys_jax.evaluate`.

    ``params`` are model-parameter tensors (:func:`repro_torch.sim.apps.
    from_numpy`); the allocation arguments may be arrays or tensors and
    are moved to the parameters' device as float64.  The static flags are
    the per-row flags of :func:`_evaluate_rowflags` held constant.
    """
    dev = params["cpi_base"].device
    banked = bool(bandwidth_partitioned) and bandwidth_banks > 1
    ipc, q_ns, traffic, mpki, exposed, occ = _evaluate_rowflags(
        params, as_f64(cache_units, dev), as_f64(bandwidth_gbps, dev),
        as_f64(prefetch_on, dev), float(total_cache_units),
        float(total_bandwidth_gbps), float(llc_extra_cycles),
        torch.tensor(bool(cache_partitioned), device=dev),
        torch.tensor(bool(bandwidth_partitioned), device=dev),
        iters=iters,
        bandwidth_banks=(as_f64(float(bandwidth_banks), dev)
                         if banked else None),
        max_banks=bandwidth_banks if banked else 1)
    return SteadyState(
        ipc=ipc, queuing_delay_ns=q_ns, traffic_gbps=traffic,
        mpki=mpki, exposed_mpki=exposed, occupancy_units=occ)


def hit_curves(params: Params, pf: torch.Tensor,
               total_units: int) -> torch.Tensor:
    """ATD hits per kilo-instruction at ``u = 0..total_units`` units:
    ``(..., n, U+1)`` for prefetch setting ``pf`` (broadcast to ``(..., n)``)."""
    dev = params["cpi_base"].device
    u = torch.arange(total_units + 1, dtype=F64, device=dev)   # (U+1,)
    p = {k: v[..., :, None] for k, v in params.items()}        # (..., n, 1)
    pf_c = pf[..., :, None]
    m = mpki_curve(p, u - p["pf_pollution"] * pf_c)           # (..., n, U+1)
    eff_miss = m * (1.0 - p["pf_cov"] * pf_c)
    return torch.clamp(p["apki"] - eff_miss, min=0.0)


def utility_curves(
    params: Params,
    prefetch_on,
    ipc,
    total_units: int,
    duration_ms: float = 1.0,
) -> torch.Tensor:
    """Counterpart of :func:`repro.sim.memsys_jax.utility_curves`:
    ATD hits(u) for u in 0..total_units, shape ``(..., n, U+1)``."""
    dev = params["cpi_base"].device
    pf = as_f64(prefetch_on, dev)
    ipc = as_f64(ipc, dev)
    hits = hit_curves(params, pf, int(total_units))
    kilo_instr = (ipc[..., :, None] * FREQ_GHZ * 1e6
                  * as_f64(duration_ms, dev) / 1000.0)
    return hits * kilo_instr
