"""Shared model building blocks (counterpart of :mod:`repro.models.layers`).

Parameters are nested dicts of tensors, laid out as the reference's
pytrees: a weight is ``(d_in, d_out)`` and multiplies as ``x @ w``, and a
layer stack keeps its leading ``L`` axis.  Compute follows the reference's
dtype policy: the parameter dtype for activations, float32 for
normalization and softmax statistics.  Every dtype is passed explicitly,
never taken from ``torch.get_default_dtype()``.

The initialisers draw from a ``torch.Generator`` on the tensor's device,
in float32, then cast.  On the ``meta`` device they allocate and draw
nothing: ``init_params(cfg, None, "meta")`` of a family module is the
layout of its parameters (:mod:`repro_torch.models.convert` checks a
reference pytree against it).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import (foldable, is_dtensor, on_shards, pin,
                                      reduce_partial, shard_start)

F32 = torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.param_dtype`` (``"bfloat16"``, ``"float32"``) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of a nested dict and the matching leaves of
    ``rest`` (same structure), keeping ``tree``'s structure
    (``jax.tree.map``'s part); leaves are visited in ``jax.tree``'s order,
    dict keys sorted."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of a nested dict in ``jax.tree``'s order (keys sorted);
    anything but a dict is a leaf (an Adafactor moment tuple too)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def layer(stack: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copy."""
    return tree_map(lambda t: t[i], stack)


def layers(stack: Dict, n: int) -> List[Dict]:
    """All ``n`` layers of a stacked parameter tree: the views
    :func:`layer` gives, taken by one ``unbind`` per leaf, so that the
    backward pass stacks the layers' gradients once (``t[i]`` per layer
    writes a gradient of the whole stack for each layer)."""
    parts = tree_map(lambda t: t.unbind(0), stack)
    return [tree_map(lambda p, i=i: p[i], parts) for i in range(n)]


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to their common dtype first,
    as ``jnp.einsum`` does (bf16 x f32 computes in f32); torch refuses
    mixed operands.  DTensor operands are made foldable first
    (:func:`repro_torch.distributed.foldable`), and the product's gradient
    comes back in its own layout (:func:`repro_torch.distributed.pin`),
    which its backward folds too."""
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return pin(torch.einsum(eq, *foldable(eq, *(o.to(dtype) for o in ops))))


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)`` whose gradient comes back in the result's own
    layout (:func:`repro_torch.distributed.pin`): a DTensor's backward
    view then undoes the forward one on every PyTorch release (2.11's
    cannot fold a gradient sharded elsewhere).  A plain tensor's reshape
    as ever."""
    return pin(x.reshape(*shape))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics (Llama/Qwen convention)."""
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(F32)).to(dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ wg) * (x @ wu) )."""
    g = F.silu(einsum("...d,df->...f", x, wg))
    u = einsum("...d,df->...f", x, wu)
    return einsum("...f,fd->...d", g * u, wd)


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """GELU MLP (whisper-style two-matrix FFN).  ``jax.nn.gelu`` defaults
    to the tanh approximation, so this one does too."""
    h = F.gelu(einsum("...d,df->...f", x, wi), approximate="tanh")
    return einsum("...f,fd->...d", h, wo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding over interleaved pairs ``(x[2i], x[2i+1])`` (not
    halves).  x: (..., S, H, Dh); positions: broadcastable (S,) or
    (..., S)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32,
                                        device=x.device) / dh))
    ang = positions.to(F32)[..., None] * inv     # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]            # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., 0::2].to(F32)
    x2 = x[..., 1::2].to(F32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoid table (seq, d_model), made in float64 with
    numpy as the reference makes it, then float32."""
    half = d_model // 2
    scale = np.log(10000.0) / max(half - 1, 1)
    inv = np.exp(-scale * np.arange(half))
    pos = np.arange(seq)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    return torch.as_tensor(table, dtype=F32, device=device)


# ------------------------------------------------------------------ #
# Initializers
# ------------------------------------------------------------------ #


def _parts(out: torch.Tensor) -> Iterator[torch.Tensor]:
    """A stacked leaf (3-D and up) one leading slice at a time, so that the
    float32 draw of a full-width layer stack never lives whole."""
    if out.dim() >= 3:
        yield from out.unbind(0)
    else:
        yield out


def dense_init(gen, shape, dtype: torch.dtype, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] at fan-in scale ``1/sqrt(shape[in_axis])``
    (the reference's ``dense_init``)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    std = 1.0 / np.sqrt(shape[in_axis])
    for part in _parts(out):
        t = torch.empty(part.shape, dtype=F32, device=out.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(t.mul_(std))
    return out


def normal_init(gen, shape, dtype: torch.dtype, std: float,
                device=None) -> torch.Tensor:
    """Normal at ``std``, drawn in float32: the embedding (0.02, the
    reference's ``embed_init``) and the SSM conv (1/K)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for part in _parts(out):
        t = torch.randn(part.shape, generator=gen, dtype=F32,
                        device=out.device)
        part.copy_(t.mul_(std))
    return out


def embed_init(gen, shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    return normal_init(gen, shape, dtype, 0.02, device)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; labels < 0 are masked.  Padded vocab
    entries (>= vocab_size) are excluded from the partition function by
    masking their logits.  Logits sharded on a mesh (a DTensor split by
    rows or by the vocabulary) stay on their shards:
    :func:`_xent_terms_on_shards`."""
    v_pad = logits.shape[-1]
    if v_pad > vocab_size:
        mask = torch.arange(v_pad, device=logits.device) < vocab_size
        logits = torch.where(mask, logits, -1e30)
    logits = logits.to(F32)
    if is_dtensor(logits) and any(p.is_shard() for p in logits.placements):
        logz, gold = _xent_terms_on_shards(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[
            ..., None].long())[..., 0]
    nll = logz - gold
    valid = (labels >= 0).to(F32)
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _xent_terms_on_shards(logits: torch.Tensor, labels: torch.Tensor):
    """``(logsumexp, gold logit)`` of sharded DTensor logits, each rank
    working on its own ``(rows, seq, vocab shard)`` slice: over a sharded
    vocabulary the max and the sum of exponentials are reductions over
    the shards (small ``(rows, seq)`` partial results; DTensor's
    ``logsumexp`` would gather the vocabulary), and each rank takes the
    gold logit of the labels inside its shard (zero elsewhere), summed
    over the vocabulary's mesh axes.  The gold logit's backward scatters
    into the rank's own slice, so no rank builds the whole logits
    gradient (as DTensor's gather does, even of logits split by rows
    alone)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    last = logits.dim() - 1
    rows = [p if p.is_shard() and not p.is_shard(last) else Replicate()
            for p in logits.placements]
    summed = [Partial() if p.is_shard(last) else r
              for p, r in zip(logits.placements, rows)]
    if is_dtensor(labels):
        labels = labels.redistribute(mesh, rows)
    else:       # the same on every rank
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim
                                    ).redistribute(mesh, rows)
    if any(p.is_shard(last) for p in logits.placements):
        top = reduce_partial(torch.amax(logits.detach(), dim=-1))
        logz = torch.log(reduce_partial(on_shards(
            _sumexp_on_shard, mesh, (summed,), (logits.placements, rows))(
                logits, top))) + top
    else:
        logz = torch.logsumexp(logits, dim=-1)
    gold = on_shards(_gold_on_shard, mesh, (summed,),
                     (logits.placements, rows, None))(
        logits, labels, shard_start(logits, last))
    return logz, reduce_partial(gold)


def _sumexp_on_shard(logits: torch.Tensor, top: torch.Tensor
                     ) -> torch.Tensor:
    """This shard's part of ``sum(exp(logits - top))`` over the
    vocabulary."""
    return torch.sum(torch.exp(logits - top[..., None]), dim=-1)


def _gold_on_shard(logits: torch.Tensor, labels: torch.Tensor,
                   offset: int) -> torch.Tensor:
    """Each label's logit where it falls in this shard (which starts at
    global index ``offset``), else 0."""
    at = labels.long() - offset
    inside = (at >= 0) & (at < logits.shape[-1])
    gold = torch.gather(logits, -1,
                        torch.clamp(at, 0, logits.shape[-1] - 1)[..., None])
    return torch.where(inside, gold[..., 0], 0.0)
