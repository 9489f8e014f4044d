"""Optimizers over nested dicts of tensors: AdamW, Adafactor and SGD
(counterpart of :mod:`repro.optim.optimizers`).

Policy, as the reference's: parameters are stored and computed in their
model dtype (bf16 for the full configs) with an f32 master copy inside the
optimizer state; AdamW keeps f32 first and second moments, Adafactor a
factored f32 second moment (rows and columns) for matrices and no first
moment.

The arithmetic is the reference's op for op: the same order of scaling,
bias correction, epsilon and weight decay, the global-norm clip summed
over the leaves in ``jax.tree``'s order (dict keys sorted), and the bias
corrections in f32.  Every division by a scalar divides by a tensor on the
leaf's device: the card turns a division by a host scalar into a product
with its reciprocal, which rounds otherwise.

Unlike the reference, an update writes its results into the tensors it
is given (the counterpart of donating them to a jitted step): the state's
``master``/``m``/``v`` tensors and the parameters are updated in place,
and the returned parameters and state hold the same tensors (``step`` is
a new tensor).  Holding two copies of a full AdamW state would not fit
one card at qwen3-8b's width.  AdamW walks each leaf in flat pieces of at
most :data:`PIECE` elements, so its f32 temporaries stay small; the
arithmetic is elementwise, so the pieces give the whole leaf's values.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map

F32 = torch.float32

#: Elements per piece of an AdamW leaf update (256 MB of f32).
PIECE = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    master: Any          # f32 params
    m: Any               # adamw: f32 momentum | adafactor: None
    v: Any               # adamw: f32 second moment | adafactor:
                         # (vr, vc) or (v,)


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _master(p: torch.Tensor) -> torch.Tensor:
    # always a copy: an f32 parameter must not alias its master
    return p.detach().to(F32, copy=True)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 tensor on ``like``'s device (a divisor)."""
    return torch.full((), value, dtype=F32, device=like.device)


def _write_params(params, master) -> None:
    """The new parameters, cast to each parameter's dtype, into ``params``."""
    with torch.no_grad():
        for p, mp in zip(tree_leaves(params), tree_leaves(master)):
            p.copy_(mp)


# ----------------------------- AdamW ------------------------------- #


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        master=tree_map(_master, params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Any, OptState]:
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(
        _scalar(grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(_scalar(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_scalar(b2, stepf), stepf)

    for master, g, m, v in zip(tree_leaves(state.master), tree_leaves(grads),
                               tree_leaves(state.m), tree_leaves(state.v)):
        # the state's own storage, in pieces (``view`` refuses a copy)
        for mp, gp, mm, vv in zip(master.view(-1).split(PIECE),
                                  g.reshape(-1).split(PIECE),
                                  m.view(-1).split(PIECE),
                                  v.view(-1).split(PIECE)):
            gp = gp.to(F32) * scale
            mm.mul_(b1).add_(gp * (1 - b1))
            vv.mul_(b2).add_(torch.square(gp).mul_(1 - b2))
            upd = mm / bc1
            upd.div_((vv / bc2).sqrt_().add_(eps))
            upd.add_(mp * weight_decay)
            mp.sub_(upd.mul_(lr))
    _write_params(params, state.master)
    return params, OptState(step, state.master, state.m, state.v)


# --------------------------- Adafactor ----------------------------- #


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> OptState:
    def second_moment(p):
        zeros = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
        if _factored(p.shape):
            return (zeros(p.shape[:-1]),                         # row
                    zeros(p.shape[:-2] + p.shape[-1:]))          # column
        return (zeros(p.shape),)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        master=tree_map(_master, params),
        m=None,
        v=tree_map(second_moment, params),
    )


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, *, lr: float,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Any, OptState]:
    step = state.step + 1
    beta2 = 1.0 - torch.pow(step.to(F32), -decay)

    for master, g, v in zip(tree_leaves(state.master), tree_leaves(grads),
                            tree_leaves(state.v)):
        g = g.to(F32)
        g2 = torch.square(g) + eps
        if len(v) == 2:
            vr, vc = v
            vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
            rfac = torch.rsqrt(
                vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps) + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g * rfac[..., None] * cfac[..., None, :]
        else:
            (vf,) = v
            vf.copy_(beta2 * vf + (1 - beta2) * g2)
            u = g * torch.rsqrt(vf + eps)
        # update clipping by RMS
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / _scalar(clip_threshold, rms), min=1.0)
        master.copy_(master - lr * (u + weight_decay * master))
    _write_params(params, state.master)
    return params, OptState(step, state.master, None, state.v)


# ----------------------------- factory ----------------------------- #


def _sgd_init(params) -> OptState:
    return OptState(torch.zeros((), dtype=torch.int32,
                                device=_device(params)), None, None, None)


def _sgd_update(lr: float):
    @torch.no_grad()
    def update(params, grads, state: OptState) -> Tuple[Any, OptState]:
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_(p - lr * g.to(p.dtype))
        return params, OptState(state.step + 1, None, None, None)
    return update


def make_optimizer(kind: str, lr: float = 3e-4, **kw):
    """Returns (init_fn, update_fn(params, grads, state) -> (params,
    state))."""
    if kind == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, lr=lr, **kw)
    if kind == "adafactor":
        return adafactor_init, lambda p, g, s: adafactor_update(
            p, g, s, lr=lr, **kw)
    if kind == "sgd":
        return _sgd_init, _sgd_update(lr)
    raise ValueError(kind)
