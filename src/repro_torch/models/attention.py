"""GQA attention: training (chunked causal), prefill and decode paths
(counterpart of :mod:`repro.models.attention`).

Plain PyTorch, as the reference's jnp path: einsum and softmax with f32
scores, no fused attention call, so the port computes what the reference
computes.  Head layout is kv-major (``repeat_kv``), caches are
``(B, Smax, Hkv, Dh)``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import is_dtensor, on_shards
from repro_torch.models.layers import F32, einsum, reshape

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return reshape(k[:, :, :, None, :].expand(b, s, h, n_rep, d),
                   b, s, h * n_rep, d)


def _causal_mask(scores: torch.Tensor, start: int) -> torch.Tensor:
    c, sk = scores.shape[-2:]
    qpos = start + torch.arange(c, device=scores.device)[:, None]
    kpos = torch.arange(sk, device=scores.device)[None, :]
    return torch.where(kpos <= qpos, scores, NEG_INF)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk: int = 1024, causal: bool = True,
                     remat_chunk: bool = True) -> torch.Tensor:
    """Chunked attention.  q: (B, Sq, H, Dh); k/v: (B, Sk, H, Dh).

    Scores are computed a q-chunk at a time, so the live score buffer is
    (B, H, chunk, Sk); ``Sq`` that ``chunk`` does not divide ends in one
    shorter chunk, as in the reference.  ``remat_chunk`` recomputes each
    chunk's scores and probabilities in the backward pass (a
    non-reentrant checkpoint per chunk, which nests inside a layer's), so
    no chunk's residuals are kept; it changes memory, not values, and
    applies only where gradients are taken.  The recompute draws no
    random numbers, so the checkpoint neither saves nor restores the RNG
    state.
    """
    if is_dtensor(q):
        return _on_rows_and_heads(q, k, v, chunk, causal, remat_chunk)
    sq, dh = q.shape[1], q.shape[-1]
    scale = dh ** -0.5
    chunk = min(chunk, sq)
    n_chunks = max(sq // chunk, 1)
    kT = k.permute(0, 2, 3, 1)   # (B, H, Dh, Sk)
    vT = v.permute(0, 2, 1, 3)   # (B, H, Sk, Dh)

    def one_chunk(q_chunk: torch.Tensor, start: int) -> torch.Tensor:
        qT = q_chunk.permute(0, 2, 1, 3)   # (B, H, C, Dh)
        scores = einsum("bhcd,bhds->bhcs", qT, kT).to(F32) * scale
        if causal:
            scores = _causal_mask(scores, start)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = einsum("bhcs,bhsd->bhcd", probs, vT)
        return out.permute(0, 2, 1, 3)     # (B, C, H, Dh)

    if remat_chunk and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        plain = one_chunk

        def one_chunk(q_chunk: torch.Tensor, start: int) -> torch.Tensor:
            return checkpoint(plain, q_chunk, start, use_reentrant=False,
                              preserve_rng_state=False)

    if n_chunks == 1:
        return one_chunk(q, 0)
    starts = [i * chunk for i in range(n_chunks)]
    if n_chunks * chunk < sq:
        starts.append(n_chunks * chunk)
    bounds = starts[1:] + [sq]
    return torch.cat([one_chunk(q[:, a:b], a)
                      for a, b in zip(starts, bounds)], dim=1)


def _on_rows_and_heads(q, k, v, chunk: int, causal: bool,
                       remat_chunk: bool) -> torch.Tensor:
    """:func:`causal_attention` of DTensors: attention is local to a batch
    row and a head, so each rank attends over its own rows and heads
    (q's layout, its sequence and head width whole; K and V taken in it)
    without a DTensor op inside."""
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard(1) or p.is_shard(3) else p
          for p in q.placements]
    q, k, v = (t.redistribute(t.device_mesh, pl) for t in (q, k, v))
    return on_shards(
        lambda q, k, v: causal_attention(q, k, v, chunk, causal,
                                         remat_chunk),
        q.device_mesh, (pl,), (pl, pl, pl))(q, k, v)


def _length_mask(scores: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """Mask cache positions ``>= cur_len`` (a scalar or per row (B,)) of
    scores whose first axis is the batch and last the cache."""
    smax = scores.shape[-1]
    mask = (torch.arange(smax, device=scores.device)[None, :]
            < cur_len.reshape(-1, 1))                     # (B|1, Smax)
    mask = mask.reshape(mask.shape[:1] + (1,) * (scores.dim() - 2)
                        + (smax,))
    return torch.where(mask, scores, NEG_INF)


def decode_attention_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cur_len: torch.Tensor) -> torch.Tensor:
    """Grouped-query decode without materializing repeated KV.

    q: (B, 1, Hq, Dh); caches: (B, Smax, Hkv, Dh), Hq = G * Hkv (kv-major
    head layout, matching ``repeat_kv``).
    """
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    scale = dh ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, dh)
    scores = einsum("bkgd,bskd->bkgs", qg, k_cache).to(F32) * scale
    scores = _length_mask(scores, cur_len)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = einsum("bkgs,bskd->bkgd", probs, v_cache)
    return out.reshape(b, 1, hq, dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cur_len: torch.Tensor) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B, 1, H, Dh); k_cache/v_cache: (B, Smax, H, Dh); cur_len: () or
    (B,) number of valid cache positions.
    """
    scale = q.shape[-1] ** -0.5
    scores = einsum("bqhd,bshd->bhqs", q, k_cache).to(F32) * scale
    scores = _length_mask(scores, cur_len)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return einsum("bhqs,bshd->bqhd", probs, v_cache)
