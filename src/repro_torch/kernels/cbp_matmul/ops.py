"""CBP blocked matmul: the CUDA kernel's wrapper and its plain version.

:func:`cbp_matmul` is the port of the Pallas kernel
``repro.kernels.cbp_matmul.kernel.cbp_matmul``: ``(M, K) @ (K, N)`` with
the planner's ``(block_m, block_n, block_k)`` knobs, an f32 accumulator
and the output in the input dtype (float32 or bfloat16), written in CUDA
C++ (``src/repro_torch/csrc/cbp_matmul.cu``).  A thread block owns one
``block_m x block_n`` output region and strides k by ``block_k``; the
ragged edge is masked in the kernel, so any positive knobs run, including
the planner's pad-aware blocks for dims with no aligned divisor.

For a CUDA tensor it launches that kernel or raises; only tensors on the
CPU go to :func:`cbp_matmul_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel (not of the plain version).
LAUNCHES = LaunchCounter("cbp_matmul")

_SUB = 64     # output sub-tile edge of a thread block (csrc: kSub)
_CHUNK = 32   # k extent staged through shared memory at once (kChunk)
_MAX_GRID_Y = 65535


def smem_footprint_bytes(block_m: int, block_n: int, block_k: int,
                         dtype_bytes: int = 2) -> int:
    """Dynamic shared memory the CUDA kernel requests for these knobs:
    the A piece (transposed, one padding column) and the B piece of one
    k step, in the input dtype.  The launcher refuses any other size."""
    sub_m, sub_n = min(block_m, _SUB), min(block_n, _SUB)
    kc = min(block_k, _CHUNK)
    return kc * ((sub_m + 1) + sub_n) * dtype_bytes


def _check(a, b, block_m: int, block_n: int, block_k: int) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("cbp_matmul takes 2-D a (M, K) and b (K, N)")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in build.DTYPE_CODES:
        raise ValueError(f"a and b must share a float32 or bfloat16 dtype, "
                         f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    for name, knob in (("block_m", block_m), ("block_n", block_n),
                       ("block_k", block_k)):
        if int(knob) < 1:
            raise ValueError(f"{name} must be >= 1, got {knob}")


def _launch_args(a, b, out, block_m: int, block_n: int,
                 block_k: int) -> tuple:
    """Arguments of ``cbp_matmul_launch`` before the stream: pointers,
    sizes, knobs, dtype code and the dynamic shared memory it requests."""
    (M, K), N = a.shape, b.shape[1]
    return (a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, block_m,
            block_n, block_k, build.DTYPE_CODES[a.dtype],
            smem_footprint_bytes(block_m, block_n, block_k,
                                 a.element_size()))


def cbp_matmul_plain(a, b, *, block_m: int = 128, block_n: int = 128,
                     block_k: int = 128):
    """``(a @ b)`` in float32, cast to ``a.dtype``: the Pallas kernel's
    arithmetic (f32 products, f32 sums; the knobs only schedule it)."""
    _check(a, b, block_m, block_n, block_k)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def cbp_matmul(a, b, *, block_m: int = 128, block_n: int = 128,
               block_k: int = 128):
    """``(M, K) @ (K, N)`` -> ``(M, N)`` in ``a.dtype``.

    CPU tensors take :func:`cbp_matmul_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch is refused.  There is no fallback from the card.
    """
    _check(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return cbp_matmul_plain(a, b, block_m=block_m, block_n=block_n,
                                block_k=block_k)
    if a.device.type != "cuda":
        raise ValueError(f"cbp_matmul runs on cuda or cpu tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk = int(block_m), int(block_n), int(block_k)
    if -(-M // bm) > _MAX_GRID_Y:
        raise ValueError(f"ceil(M / block_m) = {-(-M // bm)} exceeds the "
                         f"grid limit {_MAX_GRID_Y}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    launch = build.launcher("cbp_matmul", [build.ptr] * 3 + [build.i32] * 8)
    with torch.cuda.device(a.device):
        launch(*_launch_args(a, b, out, bm, bn, bk))
    LAUNCHES.record()
    return out
