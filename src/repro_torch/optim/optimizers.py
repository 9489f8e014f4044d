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

Under a mesh (:mod:`repro_torch.distributed`) the parameters, gradients
and state are DTensors, the state laid out by
:func:`repro_torch.launch.shardings.opt_state_specs` (ZeRO-1 over
"data").  An update first brings each gradient to its master's placements
(where ZeRO-1 reduce-scatters the data-parallel partial sums), takes the
global norm over every shard (the clip's all-reduce), updates the local
shards of the state (``to_local()``: views of the state's own storage,
never a redistributed copy), and writes each parameter from its master
gathered into the parameter's placements (:func:`_assign`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import is_dtensor
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


def _assign(dst: torch.Tensor, value: torch.Tensor) -> None:
    """``value``, cast to ``dst``'s dtype, into ``dst``'s own storage; a
    DTensor ``value`` is first redistributed to ``dst``'s placements, so
    each rank writes its own shard of ``dst``."""
    if is_dtensor(dst):
        value = value.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(value.to_local())
    else:
        dst.copy_(value)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view of its storage), a plain
    tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def _value(x: torch.Tensor) -> torch.Tensor:
    """A scalar DTensor's value as a plain tensor (partial sums reduced),
    a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _like_state(grads, master):
    """Each gradient in its master's placements (a no-op without a mesh)."""
    return tree_map(lambda g, mp: g.redistribute(mp.device_mesh,
                                                 mp.placements)
                    if is_dtensor(mp) else g, grads, master)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros in ``p``'s shape, device and (a DTensor's) placements."""
    return torch.zeros_like(p, dtype=F32, requires_grad=False)


def _new(make, params, specs=None, put=None):
    """``make(p)`` for each parameter, each passed at once through
    ``put(tensor, spec)`` with its spec from ``specs`` where ``put`` is
    given (placing a state on a mesh leaf by leaf: one leaf's unplaced
    copy lives at a time)."""
    if put is None:
        return tree_map(make, params)
    return tree_map(lambda p, sp: put(make(p), sp), params, specs)


def _step0(params, specs=None, put=None) -> torch.Tensor:
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return step if put is None else put(step, specs.step)


def _write_params(params, master) -> None:
    """The new parameters, cast to each parameter's dtype, into ``params``."""
    with torch.no_grad():
        for p, mp in zip(tree_leaves(params), tree_leaves(master)):
            _assign(p, mp)


# ----------------------------- AdamW ------------------------------- #


def adamw_init(params, specs: OptState = None, put=None) -> OptState:
    """The state of ``params``; with ``put``, each new tensor passes
    through ``put(tensor, spec)`` with its spec in ``specs`` (an
    :class:`OptState` of spec trees) as soon as it is made."""
    return OptState(
        step=_step0(params, specs, put),
        master=_new(_master, params, specs and specs.master, put),
        m=_new(_zeros, params, specs and specs.m, put),
        v=_new(_zeros, params, specs and specs.v, put),
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
    grads = _like_state(grads, state.master)
    gnorm = _value(global_norm(grads))
    scale = torch.clamp(
        _scalar(grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = _value(step).to(F32)
    bc1 = 1 - torch.pow(_scalar(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_scalar(b2, stepf), stepf)

    for master, g, m, v in zip(tree_leaves(state.master), tree_leaves(grads),
                               tree_leaves(state.m), tree_leaves(state.v)):
        master, g, m, v = (_local(t) for t in (master, g, m, v))
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


def adafactor_init(params, specs: OptState = None, put=None) -> OptState:
    """The state of ``params``, placed leaf by leaf as
    :func:`adamw_init`'s."""
    def second_moment(p):
        zeros = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
        if _factored(p.shape):
            return (zeros(p.shape[:-1]),                         # row
                    zeros(p.shape[:-2] + p.shape[-1:]))          # column
        return (_zeros(p),)

    return OptState(
        step=_step0(params, specs, put),
        master=_new(_master, params, specs and specs.master, put),
        m=None,
        v=_new(second_moment, params, specs and specs.v, put),
    )


@torch.no_grad()
def adafactor_update(params, grads, state: OptState, *, lr: float,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0) -> Tuple[Any, OptState]:
    step = state.step + 1
    beta2 = 1.0 - torch.pow(_value(step).to(F32), -decay)

    grads = _like_state(grads, state.master)
    for master, g, v in zip(tree_leaves(state.master), tree_leaves(grads),
                            tree_leaves(state.v)):
        g = g.to(F32)
        g2 = torch.square(g) + eps
        if len(v) == 2:
            vr, vc = v
            _assign(vr, beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
            _assign(vc, beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
            rfac = torch.rsqrt(
                vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps) + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g * rfac[..., None] * cfac[..., None, :]
        else:
            (vf,) = v
            _assign(vf, beta2 * vf + (1 - beta2) * g2)
            u = g * torch.rsqrt(vf + eps)
        # update clipping by RMS
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / _scalar(clip_threshold, rms), min=1.0)
        _assign(master, master - lr * (u + weight_decay * master))
    _write_params(params, state.master)
    return params, OptState(step, state.master, None, state.v)


# ----------------------------- factory ----------------------------- #


def _sgd_init(params, specs: OptState = None, put=None) -> OptState:
    return OptState(_step0(params, specs, put), None, None, None)


def _sgd_update(lr: float):
    @torch.no_grad()
    def update(params, grads, state: OptState) -> Tuple[Any, OptState]:
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            _assign(p, p - lr * g.to(p.dtype))
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
