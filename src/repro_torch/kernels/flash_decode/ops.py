"""Flash decode: the CUDA kernel's wrapper and its plain version.

:func:`flash_decode` is the port of the Pallas kernel
``repro.kernels.flash_decode.kernel.flash_decode``: one query token per
(batch, head) against a ``(B, H, Smax, Dh)`` KV cache, masked at
``cur_len``; f32 online softmax, scale ``Dh ** -0.5``, output
``acc / max(l, 1e-30)`` in the input dtype, so ``cur_len = 0`` gives
zeros.  Written in CUDA C++ (``src/repro_torch/csrc/flash_decode.cu``):
one thread block per ``block_kv`` keys of a head, a second kernel merges
the blocks' partials.  ``cur_len`` is read by the kernel from device
memory, so a 0-d tensor on the card never synchronises the host.

For CUDA tensors it launches that kernel or raises; only tensors on the
CPU go to :func:`flash_decode_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import LaunchCounter
from repro_torch.kernels import build

#: Launches of the CUDA kernel pair (one per call, not of the plain version).
LAUNCHES = LaunchCounter("flash_decode")

NEG_INF = -1e30
MAX_HEAD_DIM = 256   # csrc: kMaxHeadDim
_MAX_GRID_Y = 65535


def _check(q, k_cache, v_cache, cur_len, block_kv: int) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (B, H, Dh) and the caches "
                         "(B, H, Smax, Dh)")
    b, h, dh = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[:2] != (b, h)
            or k_cache.shape[3] != dh):
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (not (q.dtype == k_cache.dtype == v_cache.dtype)
            or q.dtype not in build.DTYPE_CODES):
        raise ValueError("q and the caches must share a float32 or "
                         "bfloat16 dtype")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")
    if block_kv < 1 or k_cache.shape[2] % block_kv:
        raise ValueError(f"Smax = {k_cache.shape[2]} must be a multiple of "
                         f"block_kv = {block_kv}")
    if isinstance(cur_len, torch.Tensor):
        if cur_len.numel() != 1 or cur_len.dtype.is_floating_point:
            raise ValueError("cur_len must be an int or a 0-d integer tensor")
        if cur_len.device != q.device:
            raise ValueError(f"cur_len is on {cur_len.device}, q on "
                             f"{q.device}")


def flash_decode_plain(q, k_cache, v_cache, cur_len, *, block_kv: int = 512):
    """Masked softmax attention of one token in float32, cast to
    ``q.dtype``: positions ``>= cur_len`` take no weight, and with no live
    position the output is zero (``acc / max(l, 1e-30)``)."""
    _check(q, k_cache, v_cache, cur_len, block_kv)
    dh, smax = q.shape[-1], k_cache.shape[2]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * dh ** -0.5
    if isinstance(cur_len, torch.Tensor):
        cur_len = cur_len.reshape(())
    live = torch.arange(smax, device=q.device) < cur_len
    s = torch.where(live, s, NEG_INF)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    acc = torch.einsum("bhs,bhsd->bhd", p, v_cache.float())
    return (acc / p.sum(-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


def flash_decode(q, k_cache, v_cache, cur_len, *, block_kv: int = 512):
    """q ``(B, H, Dh)``, caches ``(B, H, Smax, Dh)``, ``cur_len`` an int or
    a 0-d int tensor on q's device -> ``(B, H, Dh)``.

    ``Smax`` must be a multiple of ``block_kv`` (as the Pallas kernel
    asserts); on the card ``Dh <= 256``.  CPU tensors take
    :func:`flash_decode_plain`; CUDA tensors launch the kernels on the
    current stream and raise if a launch is refused.
    """
    _check(q, k_cache, v_cache, cur_len, block_kv)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cur_len,
                                  block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, not "
                         f"{q.device}")
    b, h, dh = q.shape
    smax = k_cache.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} exceeds the kernel's limit "
                         f"{MAX_HEAD_DIM}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if isinstance(cur_len, torch.Tensor):
        lens = cur_len.reshape(1).to(torch.int32)
    else:
        lens = torch.tensor([int(cur_len)], dtype=torch.int32,
                            device=q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_blk = smax // block_kv
    part = torch.empty((b * h, n_blk, dh + 2), dtype=torch.float32,
                       device=q.device)
    launch = build.launcher(
        "flash_decode",
        [build.ptr] * 6 + [build.i32] * 4 + [build.f32, build.i32])
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               lens.data_ptr(), part.data_ptr(), out.data_ptr(), b * h, smax,
               dh, int(block_kv), dh ** -0.5, build.DTYPE_CODES[q.dtype])
    LAUNCHES.record()
    return out
