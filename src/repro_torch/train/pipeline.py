"""Pipeline parallelism over one mesh axis (counterpart of
:mod:`repro.train.pipeline`).

GPipe over the "pod" axis of a :class:`DeviceMesh`: stage s (the rank at
coordinate s of the axis) holds layers ``[s L/S, (s+1) L/S)``, and
activations flow stage to stage by point-to-point sends while every other
mesh axis holds replicas that compute the same thing.  The schedule is
the reference's: on tick t stage s runs microbatch ``t - s``; the loop runs
``n_micro + S - 1`` ticks; the last stage keeps microbatch ``t - (S - 1)``
and sends the finished outputs to every stage, so the loss is computed
replicated along the axis.  A stage skips its bubble ticks (no microbatch
of its own) and passes zeros on: the reference computes there and keeps
nothing of it, so outputs and gradients are the same.

The reference differentiates through its ``ppermute`` loop; here one
:class:`torch.autograd.Function` runs the whole schedule, since autograd
prunes the backward of a hop whose output reaches no loss (stage 0 drops
what it receives; a bubble's output is never written) and a hop run on
one rank and not on its partner waits forever.  Its forward keeps each
tick's stage graph (a stage's inputs are detached leaves).  Its backward
walks the ticks in reverse: every rank runs the same hops in the same
order as in the forward, one up the pipeline between two ticks (a tick's
input cotangent to stage ``s - 1``, zeros from a bubble), and calls
``torch.autograd.grad`` on each of its own ticks, summing the parameter
gradients over them (the last tick first, as autograd sums the same
microbatches run one after another).  The last stage takes its own
cotangent of the outputs and no rank's else, and stage 0 sends the input
stream's gradient to every stage: the gradients equal the sequential
stack's, not ``S`` times them, and nothing is summed over the replicas.

Hops are ``batch_isend_irecv`` pairs (send down and receive from above,
or the reverse in the backward pass), so neither direction waits on the
other, and every rank of the axis takes part in every hop.  A one-stage
axis sends nothing: NCCL refuses two ranks of one group on one card, so
one card runs ``S = 1``, bit for bit the stack.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import distributed as D
from repro_torch.models import transformer as T
from repro_torch.models.layers import (rms_norm, softmax_xent, tree_leaves,
                                       tree_map)


class _Axis:
    """One rank's place on the pipeline axis: its stage, the number of
    stages, the axis's group and the global ranks of its neighbours."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh axes {names} have no {axis!r}")
        self.n = mesh.size(names.index(axis))
        self.stage = mesh.get_local_rank(axis)
        self.group = None
        self.prev = self.next = self.first = self.last = None
        if self.n > 1:
            import torch.distributed as dist

            self.group = mesh.get_group(axis)
            ranks = dist.get_process_group_ranks(self.group)
            self.first, self.last = ranks[0], ranks[-1]
            if self.stage > 0:
                self.prev = ranks[self.stage - 1]
            if self.stage < self.n - 1:
                self.next = ranks[self.stage + 1]

    def hop(self, send: torch.Tensor, down: bool) -> Optional[torch.Tensor]:
        """Send ``send`` one stage down the pipeline (``down``) or up it,
        and receive a tensor like it from the other side; None where the
        pipeline ends on that side."""
        import torch.distributed as dist

        to, frm = (self.next, self.prev) if down else (self.prev, self.next)
        ops, buf = [], None
        if to is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), to,
                                  self.group))
        if frm is not None:
            buf = torch.empty_like(send)
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return buf

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        import torch.distributed as dist

        dist.broadcast(t, src=src, group=self.group)


def _local_stage(p: torch.Tensor, ax: _Axis, axis: str) -> torch.Tensor:
    """This rank's stage slice of a stage-stacked leaf, a DTensor placed
    ``Shard(0)`` on ``axis`` (``Replicate`` on an axis of one) and
    ``Replicate`` elsewhere."""
    if not D.is_dtensor(p):
        raise ValueError("stage parameters must be DTensors (place_stages)")
    if p.shape[0] != ax.n:
        raise ValueError(f"stage parameter of leading size {p.shape[0]} "
                         f"on {ax.n} stages")
    names = tuple(p.device_mesh.mesh_dim_names)
    for name, pl in zip(names, p.placements):
        want = name == axis and ax.n > 1
        if not (pl.is_shard(0) if want else pl.is_replicate()):
            raise ValueError(f"stage parameter placed {p.placements} on "
                             f"{names}: want Shard(0) on {axis!r} only")
    return p.to_local().squeeze(0)     # its backward is a view: no copy


def _run(ax: _Axis, stage_fn: Callable, params, xs: torch.Tensor,
         graphs: bool = False, x_grad: bool = False):
    """The forward schedule on this rank: the outputs (every stage's, once
    the last stage has sent them) and, with ``graphs``, each of its ticks'
    ``(input, output)`` with the tick's graph (None on a bubble), the input
    a leaf that needs a gradient on every stage but the first, and there
    with ``x_grad``."""
    n, s = xs.shape[0], ax.stage
    ticks = n + ax.n - 1
    outs = torch.zeros_like(xs)
    bubble = torch.zeros_like(xs[0])
    saved: List = [None] * ticks
    recv = None
    for t in range(ticks):
        m = t - s
        out = bubble
        if 0 <= m < n:
            inp = xs[m] if s == 0 else recv
            if graphs:
                inp = inp.detach().requires_grad_(s > 0 or x_grad)
                with torch.enable_grad():
                    out = stage_fn(params, inp)
                saved[t] = (inp, out)
            else:
                out = stage_fn(params, inp)
            if out.shape != xs.shape[1:] or out.dtype != xs.dtype:
                raise ValueError(
                    f"stage_fn returned {tuple(out.shape)} {out.dtype} for "
                    f"a microbatch of {tuple(xs.shape[1:])} {xs.dtype}")
            if s == ax.n - 1:
                outs[m] = out.detach()
        if t < ticks - 1 and ax.n > 1:
            recv = ax.hop(out.detach(), down=True)
    if ax.n > 1:
        ax.broadcast(outs, ax.last)
    return outs, saved


class _Pipeline(torch.autograd.Function):
    """The schedule as one node of the caller's graph (module docstring):
    inputs the axis, ``stage_fn`` on a list of local parameter leaves,
    the stream and the leaves; output the replicated outputs."""

    @staticmethod
    def forward(ctx, ax, stage_fn, xs, *params):
        ctx.ax, ctx.x_grad = ax, ctx.needs_input_grad[2]
        ctx.ps = [p.detach().requires_grad_(g)
                  for p, g in zip(params, ctx.needs_input_grad[3:])]
        with D.use_mesh(None):
            outs, ctx.saved = _run(ax, stage_fn, ctx.ps, xs.detach(),
                                   graphs=True, x_grad=ctx.x_grad)
        return outs

    @staticmethod
    def backward(ctx, d_outs):
        ax, saved, ps = ctx.ax, ctx.saved, ctx.ps
        ctx.saved = ctx.ps = None
        n, s, ticks = d_outs.shape[0], ax.stage, len(saved)
        wrt = [p for p in ps if p.requires_grad]
        sums: List[Optional[torch.Tensor]] = [None] * len(wrt)
        dxs = torch.zeros_like(d_outs) if ctx.x_grad else None
        zero = torch.zeros_like(d_outs[0])
        d_in = d_recv = None
        with D.use_mesh(None):
            for t in reversed(range(ticks)):
                if t < ticks - 1 and ax.n > 1:
                    d_recv = ax.hop(zero if d_in is None else d_in,
                                    down=False)
                m, d_in = t - s, None
                if not 0 <= m < n:
                    continue
                inp, out = saved[t]
                saved[t] = None
                dy = d_outs[m] if s == ax.n - 1 else d_recv
                take = [inp] if inp.requires_grad else []
                gs = torch.autograd.grad(out, take + wrt, dy,
                                         allow_unused=True)
                if take:
                    d_in = gs[0]
                    if s == 0 and dxs is not None and d_in is not None:
                        dxs[m] = d_in
                for i, g in enumerate(gs[len(take):]):
                    if sums[i] is None:
                        sums[i] = g
                    elif g is not None:
                        sums[i].add_(g)     # the tick's own: free it now
                gs = g = None
        if dxs is not None and ax.n > 1:
            ax.broadcast(dxs, ax.first)
        it = iter(sums)
        grads = [next(it) if p.requires_grad else None for p in ps]
        return (None, None, dxs, *grads)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   mesh, axis: str = "pod") -> torch.Tensor:
    """Run the stage pipeline over ``axis`` of ``mesh``; returns the
    outputs ``(n_micro, mb, ...)``, the same on every rank.

    ``stage_fn(params, x) -> x`` runs one stage on one microbatch, given
    this rank's stage slice of ``stage_params`` as plain tensors (the
    reference's worker sees local arrays), and keeps its shape and dtype.
    ``stage_params`` is a tree (nested dicts or one tensor) whose leaves
    have a leading dimension of ``n_stages``, DTensors placed ``Shard(0)``
    on ``axis`` and ``Replicate`` elsewhere (:func:`place_stages`); their
    gradients come back so placed.  ``x``
    is the replicated microbatch stream ``(n_micro, mb, ...)``, a plain
    tensor on this rank's device.  Without a gradient to take the
    schedule runs and keeps no graph."""
    ax = _Axis(mesh, axis)
    leaves = tree_leaves(stage_params)
    local = [_local_stage(p, ax, axis) for p in leaves]

    def flat_fn(ps: Sequence[torch.Tensor], xb: torch.Tensor):
        it = iter(ps)
        return stage_fn(tree_map(lambda _: next(it), stage_params), xb)

    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in local)):
        return _Pipeline.apply(ax, flat_fn, x, *local)
    with D.use_mesh(None):
        return _run(ax, flat_fn, local, x)[0]


# --------------------------------------------------------------------- #
# A transformer's layer stack as the pipeline's stages.
# --------------------------------------------------------------------- #

def place_stages(tree, mesh, axis: str = "pod"):
    """A tree of layer-stacked tensors ``(L, ...)``, the same on every
    rank, as ``pipeline_apply``'s stage parameters: each leaf seen as
    ``(S, L / S, ...)`` (``S`` the size of ``axis``) and placed ``Shard(0)``
    on ``axis`` (``distributed.placements`` of ``P(axis)``), ``Replicate``
    elsewhere.  Each rank's shard is a view of its own stage's layers, so
    placing copies nothing; each leaf is a new leaf DTensor with the
    ``requires_grad`` of the tensor it views."""
    from torch.distributed.tensor import DTensor

    ax = _Axis(mesh, axis)
    pl = D.placements(D.P(axis), mesh)

    def stage(t):
        if t.shape[0] % ax.n:
            raise ValueError(f"{t.shape[0]} layers on {ax.n} stages")
        k = t.shape[0] // ax.n
        local = t.detach()[ax.stage * k:(ax.stage + 1) * k].unsqueeze(0)
        return DTensor.from_local(local, mesh, pl, run_check=False
                                  ).requires_grad_(t.requires_grad)

    return tree_map(stage, tree)


def layer_stage(cfg) -> Callable:
    """``stage_fn`` of a transformer's layers: one stage's slice of the
    stacked ``params["layers"]`` run as ``transformer.forward`` runs the
    stack (each layer under ``cfg.remat``)."""
    def stage_fn(layers, x):
        positions = torch.arange(x.shape[1], device=x.device)
        return T.layer_stack(layers, cfg, x, positions)

    return stage_fn


def microbatch_loss(model, batch, n_micro: int, mesh=None,
                    stages=None) -> torch.Tensor:
    """The mean over ``n_micro`` microbatches of a transformer's token
    loss on ``batch`` (``tokens`` and ``labels`` of ``n_micro * mb``
    rows): the tokens embedded at once, then each microbatch through the
    layers, final norm, head and cross-entropy.  Without ``mesh`` the
    layers are ``transformer.forward``'s, a microbatch at a time; with it
    they run on ``pipeline_apply`` over "pod" with ``stages``
    (``place_stages`` of ``model.params["layers"]``) and the rest runs on
    every rank."""
    cfg, params = model.cfg, model.params
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"microbatch_loss runs the dense and MoE "
                         f"transformers, not {cfg.family}")
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    labels = torch.as_tensor(batch["labels"], device=model.device)
    if tokens.shape[0] % n_micro:
        raise ValueError(f"{tokens.shape[0]} rows in {n_micro} microbatches")
    tokens = tokens.reshape(n_micro, -1, *tokens.shape[1:])
    labels = labels.reshape(n_micro, -1, *labels.shape[1:])
    x = T.embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[-1], device=x.device)
    if mesh is None:
        hidden = [T.forward(params, cfg, x[m], positions)
                  for m in range(n_micro)]
    else:
        h = pipeline_apply(layer_stage(cfg), stages, x, mesh)
        hidden = [rms_norm(h[m], params["final_norm"], cfg.norm_eps)
                  for m in range(n_micro)]
    losses = [softmax_xent(T.logits_fn(params, cfg, hd), labels[m],
                           cfg.vocab_size) for m, hd in enumerate(hidden)]
    return sum(losses) / n_micro
