"""Flash-attention forward: the CUDA kernel's wrapper and its plain
version.

:func:`flash_attention` is the port of the Pallas kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd``: attention
over ``(B, H, S, Dh)`` q/k/v, causal (mask ``kpos <= qpos`` from index 0,
also when ``Sq != Sk``) or not, scale ``Dh ** -0.5``, f32 softmax
statistics, output in the input dtype; written in CUDA C++ for Hopper
(``src/repro_torch/csrc/flash_attention.cu``): one tensor-core kernel
(``wgmma`` fed by a TMA ring of K/V stages), bf16 directly (P split into
two bf16 parts) and float32 as three TF32 products (3xTF32).

The knobs keep their meaning: a thread block owns ``block_q`` query rows
of one head, walked in tiles of 128 (bf16) or 64 (float32) rows, and
``block_kv`` is the step of the Pallas kernel's causal block skip, which
the kernel's own skip (keys up to each tile's last row) never exceeds.
Head widths up to 128 run, padded to 64 or 128 in shared memory.

Tiles are loaded by TMA when q, k and v start on 16-byte boundaries and a
row of ``Dh`` elements is a multiple of 16 bytes (:func:`tma_loads`),
else by the producer warp into the same layouts, in the same kernel.

For CUDA tensors it launches that kernel or raises; only tensors on the
CPU go to :func:`flash_attention_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel (not of the plain version).
LAUNCHES = LaunchCounter("flash_attention")

NEG_INF = -1e30
MAX_HEAD_DIM = 128   # the kernel's shared-memory tiles (csrc: kMaxDh)
_MAX_BLOCKS = 2 ** 31 - 1
#: Per element size: consumer warpgroups (64 query rows each), keys of a
#: ring stage, ring stages, and (float32) stages of the split ring that the
#: splitter warpgroup fills (csrc: Cfg).
_CONFIG = {2: (2, 128, 3, 0), 4: (1, 32, 1, 2)}


def attention_smem_bytes(dh: int, dtype_bytes: int = 2) -> int:
    """Dynamic shared memory the CUDA kernel requests at head dim ``dh``
    (padded to 64 or 128): the Q tile (float32: and Q lo), the ring's K
    and V stages, in float32 the split stages (K hi, K lo, V^T hi, V^T
    lo), and the mbarriers.  The knobs do not change it."""
    kd = 64 if dh <= 64 else 128
    wg, keys, stages, splits = _CONFIG[dtype_bytes]
    q = 64 * wg * kd * dtype_bytes
    kv = keys * kd * dtype_bytes
    q_lo = q if splits else 0
    return (q + q_lo + stages * 2 * kv + splits * 4 * kv
            + (2 * stages + 2 * splits + 3) * 8)


def tma_loads(q, k, v) -> bool:
    """Whether the kernel loads its tiles by TMA: q, k and v start on
    16-byte boundaries and a row (``Dh`` elements) is a multiple of 16
    bytes.  Otherwise the producer warp copies them."""
    return (all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and q.shape[3] * q.element_size() % 16 == 0)


def _check(q, k, v, block_q: int, block_kv: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, Dh)")
    b, h, sq, dh = q.shape
    if (k.shape != v.shape or k.shape[:2] != (b, h)
            or k.shape[3] != dh):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPE_CODES:
        raise ValueError("q, k and v must share a float32 or bfloat16 dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if block_q < 1 or block_kv < 1:
        raise ValueError("block_q and block_kv must be >= 1")
    sk = k.shape[2]
    if sq % block_q or sk % block_kv:
        raise ValueError(f"seq lengths ({sq}, {sk}) must be multiples of "
                         f"block_q={block_q} and block_kv={block_kv}")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 128, block_kv: int = 128):
    """Softmax attention in float32 (scores, statistics and the product
    with V), cast to ``q.dtype``; masked scores are ``NEG_INF``."""
    _check(q, k, v, block_q, block_kv)
    sq, dh = q.shape[2], q.shape[3]
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_kv: int = 128):
    """``(B, H, Sq, Dh)`` x ``(B, H, Sk, Dh)`` -> ``(B, H, Sq, Dh)``.

    ``Sq`` and ``Sk`` must be multiples of ``block_q`` and ``block_kv``
    (as the Pallas kernel asserts); on the card ``Dh <= 128``.  CPU
    tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel on the current stream and raise if the launch is refused.
    """
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} exceeds the kernel's limit "
                         f"{MAX_HEAD_DIM}")
    if b * h * (sq // block_q) > _MAX_BLOCKS:
        raise ValueError(f"B * H * Sq / block_q = {b * h * (sq // block_q)} "
                         f"exceeds the grid limit {_MAX_BLOCKS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = build.launcher(
        "flash_attention",
        [build.ptr] * 4 + [build.i32] * 7 + [build.f32, build.i32])
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b * h, sq, sk, dh, int(block_q), int(block_kv), int(causal),
               dh ** -0.5, build.DTYPE_CODES[q.dtype])
    LAUNCHES.record()
    return out
