"""UCP Lookahead greedy: the CUDA kernel's wrapper and its plain version.

:func:`lookahead_greedy` is the port of the Pallas kernel
``repro.kernels.lookahead_greedy.kernel.lookahead_greedy_rows``: one warp
per row of a ``(B, n, U+1)`` float64 curve batch, each client's best step
cached between trips, written in CUDA C++
(``src/repro_torch/csrc/lookahead_greedy.cu``) and bound through
``ctypes``.  For a CUDA tensor it launches that kernel or raises; only a
tensor on the CPU goes to :func:`lookahead_greedy_plain`, the batched
trip loop that mirrors ``_lookahead_kernel`` op for op.

Both return the greedy allocation and the leftover balance; the caller
applies the zero-utility spread (:func:`repro_torch.core.cache_controller.
_zero_spread`).  Kernel and plain version agree bit for bit: same f64
division, same first-max tie-breaks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel (not of the plain version).
LAUNCHES = LaunchCounter("lookahead_greedy")

_I32 = torch.int32


def _check(curves, min_units, active, remaining, total_units: int):
    if curves.dim() != 3 or curves.dtype != torch.float64:
        raise ValueError("curves must be a (B, n, U+1) float64 tensor")
    B, n, U1 = curves.shape
    if total_units < 1 or U1 != total_units + 1:
        raise ValueError(
            f"curves must have total_units + 1 = {total_units + 1} "
            f"columns, got {U1}")
    for name, t, shape in (("min_units", min_units, (B,)),
                           ("active", active, (B, n)),
                           ("remaining", remaining, (B,))):
        if t.dtype != _I32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be an int32 tensor of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != curves.device:
            raise ValueError(f"{name} is on {t.device}, curves on "
                             f"{curves.device}")


def lookahead_greedy_plain(curves, min_units, active, remaining, *,
                           total_units: int, work: Optional[dict] = None):
    """Batched trip loop over ``(B, n, U)`` candidates, ``_lookahead_kernel``
    op for op; rows that are done (balance spent or stuck) are frozen.

    ``work``, if given, gains ``trips`` and ``candidates`` (the candidate
    steps with ``k <= cap`` in live rows, i.e. the divisions the kernel
    does) — the operation count of the kernel's bound.
    """
    _check(curves, min_units, active, remaining, total_units)
    B, n, _ = curves.shape
    U = total_units
    dev = curves.device
    ks = torch.arange(1, U + 1, dtype=_I32, device=dev)            # (U,)
    ksf = ks.to(curves.dtype)
    act = active != 0
    rem = remaining[:, None]
    iota_n = torch.arange(n, device=dev)
    alloc = min_units[:, None].expand(B, n).clone()
    balance = U - n * min_units
    stuck = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(U + 1):
        live = (balance > 0) & ~stuck
        if not bool(live.any()):
            break
        cap = torch.where(act, torch.minimum(balance[:, None], rem - alloc),
                          0)
        idx = torch.clamp(alloc[:, :, None] + ks, max=U)
        base = torch.gather(curves, 2, alloc[:, :, None].long())
        gain = torch.gather(curves, 2, idx.long()) - base
        mus = torch.where(ks <= cap[:, :, None], gain / ksf, -torch.inf)
        # argmax picks the FIRST max: smallest k, then lowest client.
        k_best = torch.argmax(mus, dim=2).to(_I32) + 1             # (B, n)
        mu_best = torch.amax(mus, dim=2)
        i_best = torch.argmax(mu_best, dim=1)                       # (B,)
        mu_sel = torch.amax(mu_best, dim=1)
        do_step = live & (mu_sel > 0.0)
        at_i = (iota_n[None, :] == i_best[:, None]) & do_step[:, None]
        k_sel = torch.gather(k_best, 1, i_best[:, None])[:, 0]
        alloc = alloc + torch.where(at_i, k_best, 0)
        balance = balance - torch.where(do_step, k_sel, 0)
        stuck = stuck | (live & ~(mu_sel > 0.0))
        if work is not None:
            work["trips"] = work.get("trips", 0) + 1
            work["candidates"] = work.get("candidates", 0) + int(
                torch.where(live[:, None], cap.clamp(min=0), 0).sum())
    return alloc, balance


def lookahead_greedy(curves, min_units, active, remaining, *,
                     total_units: int):
    """``(B, n, U+1)`` f64 curves -> ``((B, n) int32 alloc, (B,) int32
    balance)``; ``min_units``/``remaining`` are ``(B,)`` int32 and
    ``active`` ``(B, n)`` int32.

    CPU tensors take :func:`lookahead_greedy_plain`; CUDA tensors launch
    the kernel on the current stream (no synchronisation) and raise if the
    launch is refused.  There is no fallback from the card.
    """
    if curves.device.type == "cpu":
        return lookahead_greedy_plain(curves, min_units, active, remaining,
                                      total_units=total_units)
    if curves.device.type != "cuda":
        raise ValueError(f"lookahead_greedy runs on cuda or cpu tensors, "
                         f"not {curves.device}")
    _check(curves, min_units, active, remaining, total_units)
    for name, t in (("curves", curves), ("min_units", min_units),
                    ("active", active), ("remaining", remaining)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n, _ = curves.shape
    alloc = torch.empty((B, n), dtype=_I32, device=curves.device)
    balance = torch.empty((B,), dtype=_I32, device=curves.device)
    if B == 0:
        return alloc, balance
    launch = build.launcher("lookahead_greedy",
                            [build.ptr] * 6 + [build.i32] * 3)
    with torch.cuda.device(curves.device):
        launch(curves.data_ptr(), min_units.data_ptr(), active.data_ptr(),
               remaining.data_ptr(), alloc.data_ptr(), balance.data_ptr(),
               B, n, int(total_units))
    LAUNCHES.record()
    return alloc, balance
