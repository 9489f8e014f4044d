"""CBP blocked matmul: the CUDA kernel's wrapper and its plain version.

:func:`cbp_matmul` is the port of the Pallas kernel
``repro.kernels.cbp_matmul.kernel.cbp_matmul``: ``(M, K) @ (K, N)`` with
the planner's ``(block_m, block_n, block_k)`` knobs, an f32 accumulator
and the output in the input dtype (float32 or bfloat16), written in CUDA
C++ for Hopper (``src/repro_torch/csrc/cbp_matmul.cu``): one tensor-core
kernel (``wgmma`` fed by a ring of shared-memory stages), bf16 directly
and float32 as three TF32 products (3xTF32, f32 accuracy).

The knobs keep their meaning:

* ``block_m x block_n`` is the output region one thread block owns; it
  walks the region in 128 x 128 tiles and masks what lies past the region
  or the matrix, so any positive knobs run, including the planner's
  pad-aware blocks for dims with no aligned divisor;
* ``block_k`` is the k depth kept in flight: the ring has
  ``S = clamp(ceil(block_k / 32), 2, the stages that fit in 232,448
  bytes)`` stages of 32 k each (at most 14 in bf16, 4 in float32, whose
  TF32 split tiles take 96 KiB).

Tiles are loaded by TMA when both bases and both row strides (``K`` and
``N`` elements) are multiples of 16 bytes (:func:`tma_loads`), else by the
producer threads into the same layouts, in the same kernel.

For a CUDA tensor it launches that kernel or raises; only tensors on the
CPU go to :func:`cbp_matmul_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel (not of the plain version).
LAUNCHES = LaunchCounter("cbp_matmul")

_TILE = 128        # output tile edge of the kernel (csrc: kTile)
_KT = 32           # k depth of one ring stage (kT)
_BAR_BYTES = 16    # the two mbarriers of a stage
_MAX_SMEM = 232448  # shared memory one block may use on an H100
#: The float32 TF32 split tiles: 2 consumer warpgroups x (64 rows of A +
#: 128 rows of B) x kT x (hi, lo) x 4 bytes.
_SPLIT_F32 = 2 * (64 + _TILE) * _KT * 2 * 4
_MAX_GRID_Y = 65535


def _stage_bytes(dtype_bytes: int) -> int:
    """One ring stage: the A and B tiles of 32 k and two mbarriers."""
    return 2 * _TILE * _KT * dtype_bytes + _BAR_BYTES


def _split_bytes(dtype_bytes: int) -> int:
    return _SPLIT_F32 if dtype_bytes == 4 else 0


def ring_stages(block_k: int, dtype_bytes: int = 2) -> int:
    """Stages of the kernel's ring for ``block_k``: ceil(block_k / 32),
    at least 2, at most what fits beside the float32 split tiles."""
    cap = (_MAX_SMEM - _split_bytes(dtype_bytes)) // _stage_bytes(dtype_bytes)
    return min(max(-(-int(block_k) // _KT), 2), cap)


def smem_footprint_bytes(block_m: int, block_n: int, block_k: int,
                         dtype_bytes: int = 2) -> int:
    """Dynamic shared memory the CUDA kernel requests for these knobs:
    the ring (A and B tiles of 32 k per stage, in the input dtype, and
    each stage's two mbarriers), plus the TF32 split tiles in float32.
    ``block_m`` and ``block_n`` do not change it.  The launcher refuses
    any other size."""
    return (_split_bytes(dtype_bytes)
            + ring_stages(block_k, dtype_bytes) * _stage_bytes(dtype_bytes))


def tma_loads(a, b) -> bool:
    """Whether the kernel loads its tiles by TMA: both bases and both row
    strides are multiples of 16 bytes.  Otherwise the producer threads
    copy them."""
    (_, K), N = a.shape, b.shape[1]
    elt = a.element_size()
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and K * elt % 16 == 0 and N * elt % 16 == 0)


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
    sizes, knobs, the load stage (1: TMA), dtype code and the dynamic
    shared memory it requests."""
    (M, K), N = a.shape, b.shape[1]
    return (a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, block_m,
            block_n, block_k, int(tma_loads(a, b)),
            build.DTYPE_CODES[a.dtype],
            smem_footprint_bytes(block_m, block_n, block_k,
                                 a.element_size()))


def cbp_matmul_plain(a, b, *, block_m: int = 128, block_n: int = 128,
                     block_k: int = 128):
    """``(a @ b)`` summed in float64 and rounded once to ``a.dtype``: the
    exact product that the Pallas kernel's f32 products and f32 sums
    approximate (the knobs only schedule it).  Not a float32 sum: at
    K = 4096 the card's float32 ``torch.matmul`` lies beyond the float32
    limit of ``kernels/tolerance.py`` from the exact product itself."""
    _check(a, b, block_m, block_n, block_k)
    return torch.matmul(a.double(), b.double()).to(a.dtype)


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
    launch = build.launcher("cbp_matmul", [build.ptr] * 3 + [build.i32] * 9)
    with torch.cuda.device(a.device):
        launch(*_launch_args(a, b, out, bm, bn, bk))
    LAUNCHES.record()
    return out
