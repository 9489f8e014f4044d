"""Int8 gradient compression with error feedback (counterpart of
:mod:`repro.optim.grad_compress`).

Gradients are quantized per tensor to int8 with an f32 scale before the
data-parallel reduction; the quantization error is carried in an error-
feedback accumulator so the compression is unbiased over time (1-bit
Adam-style).  The scale divides by a tensor on the gradient's device, as
the reference divides: the card turns a division by a host scalar into a
product with its reciprocal, which would change int8 values.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.optimizers import F32, tree_map


def _one(g: torch.Tensor, e: torch.Tensor):
    g = g.to(F32) + e
    scale = (torch.clamp(torch.max(torch.abs(g)), min=1e-12)
             / torch.full((), 127.0, dtype=F32, device=g.device))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    err = g - q.to(F32) * scale
    return q, scale, err


def compress_grads(grads, error_feedback=None) -> Tuple[Any, Any, Any]:
    """Returns (q_grads int8, scales f32, new_error_feedback)."""
    if error_feedback is None:
        error_feedback = tree_map(
            lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)
    out = tree_map(_one, grads, error_feedback)
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def decompress_grads(q_grads, scales):
    return tree_map(lambda q, s: q.to(F32) * s, q_grads, scales)
