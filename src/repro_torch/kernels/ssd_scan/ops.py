"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper and its plain version.

:func:`ssd_scan` is the port of the Pallas kernel
``repro.kernels.ssd_scan.kernel.ssd_scan``: per (batch, head), the
chunked SSD form of the state-space recurrence (an intra-chunk masked
decay product plus a ``(P, N)`` state carried across chunks in order),
B and C shared by the heads of a batch row, f32 math, output in x's dtype;
written in CUDA C++ as one tensor-core kernel (``wgmma`` fed by TMA,
``src/repro_torch/csrc/ssd_scan.cu``).

:func:`ssd_scan_plain` is the sequential recurrence itself, step by step
(the reference's ``ssd_ref``): the chunked kernel must match it within a
stated tolerance, since the chunk only reorders the sums.

For CUDA tensors :func:`ssd_scan` launches the kernel or raises; only
tensors on the CPU go to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel (not of the plain version).
LAUNCHES = LaunchCounter("ssd_scan")

_TILE = 64           # steps of a tile (csrc: kT)
MAX_HEAD_DIM = 128   # P (csrc: kMaxP)
MAX_STATE_DIM = 128  # N (csrc: kMaxN)
MAX_STATE = 8192     # padded P * padded N: one warpgroup's registers

#: Per element size: bf16 pieces of a raw input, B / x stages, raw f32
#: box slots (csrc: Cfg<T>).
_CFG = {4: (2, 2, 3), 2: (1, 4, 0)}


def _pad(n: int) -> int:
    """P or N as the kernel stores it: 64, else a multiple of 64."""
    return 64 if n <= 64 else 64 * -(-n // 64)


def _up1024(n: int) -> int:
    return -(-n // 1024) * 1024


def smem_bytes(head_dim: int, state_dim: int, chunk: int,
               dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of a launch (csrc: ``ssd_scan_smem_bytes``):
    two C stages, the ring of B / x stages, the state's bf16 hi and lo,
    float32's raw box ring, the mbarriers and two tables of 16 bytes per
    64-step tile of the chunk.  P and N count padded to 64 or 128."""
    pieces, stages, raw = _CFG[dtype_bytes]
    kp, kn, t = _pad(head_dim), _pad(state_dim), _TILE
    return (2 * _up1024(pieces * t * kn * 2 + t * 4)
            + stages * _up1024(pieces * t * (kn + kp) * 2 + t * 8)
            + 2 * kp * kn * 2 + raw * t * 128 + 256
            + 32 * -(-chunk // t))


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError("x must be (B, S, H, P)")
    b, s, h, p = x.shape
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must "
                         f"be (B, S, N) for x {tuple(x.shape)}")
    if (not (x.dtype == dt.dtype == Bm.dtype == Cm.dtype)
            or x.dtype not in build.DTYPE_CODES):
        raise ValueError("x, dt, Bm and Cm must share a float32 or bfloat16 "
                         "dtype")
    if not A.dtype.is_floating_point:
        raise ValueError("A must be a float tensor")
    if not (x.device == dt.device == A.device == Bm.device == Cm.device):
        raise ValueError("all inputs must be on one device")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq_len {s} must be a multiple of chunk {chunk}")


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The sequential SSD recurrence in float32, one step at a time:
    ``state = exp(dt A) state + x dt B^T``, ``y = C . state``."""
    _check(x, dt, A, Bm, Cm, chunk)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])                 # (b, h)
        state = (decay[:, :, None, None] * state
                 + torch.einsum("bhp,bn,bh->bhpn", xf[:, t], Bf[:, t],
                                dtf[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)``, Bm/Cm
    ``(B, S, N)`` -> y ``(B, S, H, P)`` in x's dtype.

    ``S`` must be a multiple of ``chunk`` (as the Pallas kernel asserts);
    on the card ``P <= 128``, ``N <= 128``, P and N padded to 64 or 128
    multiply to at most 8192, and the shared memory of :func:`smem_bytes`
    must fit the card's per-block limit.  CPU tensors
    take :func:`ssd_scan_plain`; CUDA tensors launch the kernel on the
    current stream and raise if the launch is refused.
    """
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                         f"{x.device}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if (p > MAX_HEAD_DIM or n > MAX_STATE_DIM
            or _pad(p) * _pad(n) > MAX_STATE):
        raise ValueError(f"(P, N) = ({p}, {n}) exceeds the kernel's limits "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE_DIM} and, "
                         f"each padded to 64 or 128, P * N <= {MAX_STATE}")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    need = smem_bytes(p, n, chunk, x.element_size())
    if need > limit:
        raise ValueError(f"chunk {chunk} needs {need} bytes of shared "
                         f"memory; the card allows {limit}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    a32 = A.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch = build.launcher("ssd_scan",
                            [build.ptr] * 6 + [build.i32] * 7)
    with torch.cuda.device(x.device):
        launch(x.data_ptr(), dt.data_ptr(), a32.data_ptr(), Bm.data_ptr(),
               Cm.data_ptr(), out.data_ptr(), b, s, h, p, n, int(chunk),
               build.DTYPE_CODES[x.dtype])
    LAUNCHES.record()
    return out
