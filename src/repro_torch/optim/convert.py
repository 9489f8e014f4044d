"""Optimizer states carried over from the JAX package.

:func:`opt_state_from_jax` turns the reference's ``OptState`` (numpy
leaves, or anything ``np.asarray`` reads, in the reference's field layout:
``step``, ``master``, ``m``, ``v``) into the port's, checked against the
model's parameter layout as :func:`repro_torch.models.params_from_jax`
checks parameters: a missing or unused leaf, or a shape that is not the
parameter's (or, for an Adafactor moment, its factored row or column),
raises.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import OptState, _factored


def opt_state_from_jax(cfg: ModelConfig, state,
                       device: DeviceLike = None) -> OptState:
    """The port's :class:`OptState` of ``cfg``'s parameters holding the
    reference's ``state`` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    layout = init_params(cfg, None, "meta")

    def tensor(value, shape, path):
        a = np.asarray(value)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{tuple(shape)}")
        if a.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
            return torch.from_numpy(
                a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    def moments(p, value, path):
        if not isinstance(value, (tuple, list)):
            return tensor(value, p.shape, path)
        shapes = ((p.shape[:-1], p.shape[:-2] + p.shape[-1:])
                  if _factored(p.shape) else (p.shape,))
        if len(value) != len(shapes):
            raise ValueError(f"{path}: {len(value)} moments, expected "
                             f"{len(shapes)}")
        return tuple(tensor(v, s, f"{path}/{i}")
                     for i, (v, s) in enumerate(zip(value, shapes)))

    def tree(want, src, path, leaf):
        if src is None:
            return None
        if not isinstance(src, Mapping):
            raise TypeError(f"{path}: expected a dict of leaves, got "
                            f"{type(src).__name__}")
        missing = [k for k in want if k not in src]
        unused = [k for k in src if k not in want]
        if missing or unused:
            raise KeyError(f"{path}: missing {missing}, unused {unused}")
        return {k: tree(w, src[k], f"{path}/{k}", leaf)
                if isinstance(w, dict) else leaf(w, src[k], f"{path}/{k}")
                for k, w in want.items()}

    return OptState(
        step=torch.as_tensor(np.asarray(state.step), dtype=torch.int32,
                             device=dev),
        master=tree(layout, state.master, "master",
                    lambda p, v, path: tensor(v, p.shape, path)),
        m=tree(layout, state.m, "m",
               lambda p, v, path: tensor(v, p.shape, path)),
        v=tree(layout, state.v, "v", moments))
