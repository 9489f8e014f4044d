"""Flash-attention forward: the CUDA kernel's wrapper and its plain
version.

:func:`flash_attention` is the port of the Pallas kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd``: attention
over ``(B, H, S, Dh)`` q/k/v, causal (mask ``kpos <= qpos`` from index 0,
also when ``Sq != Sk``) or not, scale ``Dh ** -0.5``, f32 softmax
statistics, output in the input dtype; written in CUDA C++
(``src/repro_torch/csrc/flash_attention.cu``).  A thread block owns
``block_q`` query rows of one head and strides the keys by ``block_kv``.

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
_MAX_GRID_Y = 65535


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
    if sq // block_q > _MAX_GRID_Y:
        raise ValueError(f"Sq / block_q = {sq // block_q} exceeds the grid "
                         f"limit {_MAX_GRID_Y}")
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
