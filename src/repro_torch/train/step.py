"""Train-step builder: loss -> grads (optionally microbatched) ->
optimizer (counterpart of :mod:`repro.train.step`).

``build_train_step(model, tcfg)`` turns gradients on for ``model``'s
parameters (``model.requires_grad_(True)``: :func:`repro_torch.models.
build` leaves them frozen, as serving wants them) and returns
``(init_opt_state, train_step)``, where ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` as in the reference.  ``params``
is ``model.params``, the model's own tensors.  The step writes the new
parameters and optimizer state into the tensors it is given (the
counterpart of the reference launcher's ``donate_argnums=(0, 1)``: see
:mod:`repro_torch.optim.optimizers`) and returns them.

Gradients come from ``torch.autograd.grad``, in the parameters' dtype as
``jax.value_and_grad`` gives them.  With ``microbatches = k > 1`` the
batch splits along its first axis into ``k`` slices; each slice's
gradient is cast to f32 and added into f32 accumulators, the loss summed
in f32, and both multiplied by ``1.0 / k``, as the reference's scan does
(``.backward()`` would sum into ``.grad`` in the parameters' dtype,
another computation for bf16 parameters).

Under a mesh (:func:`repro_torch.distributed.use_mesh`; the parameters
placed by :func:`repro_torch.launch.shardings.param_specs`) the same step
runs on DTensors: ``init_opt_state`` lays the optimizer state out by
``opt_state_specs`` (ZeRO-1), leaf by leaf, each microbatch is distributed by
``batch_specs`` (every rank passes the same batch), the loss and
gradients run where plain tensors made inside the model count as
replicated (:func:`repro_torch.distributed.mesh_context`), the f32
accumulators take the gradients' placements, and ``metrics["loss"]`` is
the loss's value on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.distributed import get_mesh, is_dtensor, mesh_context
from repro_torch.launch.shardings import batch_specs, opt_state_specs, place
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model, family_module
from repro_torch.optim.optimizers import F32, make_optimizer


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    microbatches: int = 1
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _unflatten(params, flat: List[torch.Tensor]):
    """``flat`` (in :func:`tree_leaves` order) in ``params``' structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), params)


def _chunks(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """``k`` slices of ``x`` along its first axis.  A DTensor sharded on
    that axis (a batch placed by ``batch_specs``) is cut on each rank's
    own rows, so no row moves: microbatch ``i`` holds the ``i``-th slice
    of every rank's block, and each microbatch's rows stay spread over
    the same ranks (a DTensor chunk would gather the whole batch on every
    rank first).  The mean over equal microbatches is the same."""
    if not is_dtensor(x) or not any(p.is_shard(0) for p in x.placements) \
            or x.to_local().shape[0] % k:
        return list(x.chunk(k))
    from torch.distributed.tensor import DTensor

    shape = (x.shape[0] // k,) + tuple(x.shape[1:])
    return [DTensor.from_local(part, x.device_mesh, x.placements,
                               run_check=False, shape=shape,
                               stride=torch.empty(shape,
                                                  device="meta").stride())
            for part in x.to_local().chunk(k)]


def _split(batch: Dict[str, torch.Tensor], k: int
           ) -> List[Dict[str, torch.Tensor]]:
    """``k`` microbatches along the first axis; 0-d leaves stay whole."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(k)]
    for name, x in batch.items():
        if x.dim() == 0:
            parts = [x] * k
        else:
            if x.shape[0] % k:
                raise ValueError(f"batch {name!r} of {x.shape[0]} rows does "
                                 f"not split into {k} microbatches")
            parts = _chunks(x, k)
        for mb, part in zip(out, parts):
            mb[name] = part
    return out


def build_train_step(model: Model, tcfg: TrainStepConfig
                     ) -> Tuple[Callable, Callable]:
    """Returns (init_opt_state, train_step)."""
    kw: Dict[str, Any] = {}
    if tcfg.optimizer == "adamw":
        kw = dict(weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    init_opt, update = make_optimizer(tcfg.optimizer, tcfg.lr, **kw)
    model.requires_grad_(True)
    loss_fn = family_module(model.cfg).loss_fn

    def value_and_grad(params, batch):
        mesh = get_mesh()
        if mesh is not None:
            batch = place(batch, batch_specs(model.cfg, batch, mesh), mesh)
        flat = tree_leaves(params)
        with mesh_context():
            loss = loss_fn(params, model.cfg, batch)
            # a parameter the loss does not read gets zeros, as in JAX
            grads = torch.autograd.grad(
                loss, flat, allow_unused=True, materialize_grads=True)
        loss = loss.detach()
        return (loss.full_tensor() if is_dtensor(loss) else loss), grads

    def grads_fn(params, batch):
        if tcfg.microbatches <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, _unflatten(params, list(grads))
        k = tcfg.microbatches
        loss_sum = torch.zeros((), dtype=F32, device=model.device)
        g_sum = None
        for mb in _split(batch, k):
            loss, grads = value_and_grad(params, mb)
            loss_sum = loss_sum + loss
            if g_sum is None:   # in the gradients' placements on a mesh
                g_sum = [torch.zeros_like(g, dtype=F32) for g in grads]
            for acc, g in zip(g_sum, grads):
                acc.add_(g.to(F32))
            del grads
        inv = 1.0 / k
        return loss_sum * inv, _unflatten(params,
                                          [g.mul_(inv) for g in g_sum])

    def init_opt_state(params):
        mesh = get_mesh()
        if mesh is None:
            return init_opt(params)
        # the specs from the state's shapes alone, then the state made and
        # placed leaf by leaf (a whole unplaced AdamW state of a full
        # config would not fit beside the parameters)
        shapes = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                device="meta"), params)
        specs = opt_state_specs(model.cfg, init_opt(shapes), shapes, mesh,
                                tcfg.optimizer)
        return init_opt(params, specs,
                        lambda t, sp: place(t, sp, mesh))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, grads = grads_fn(params, batch)
        params, opt_state = update(params, grads, opt_state)
        metrics = {"loss": loss.to(F32)}
        return params, opt_state, metrics

    return init_opt_state, train_step
