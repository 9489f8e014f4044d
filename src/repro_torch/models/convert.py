"""Parameters carried over from the JAX package's pytrees.

:func:`params_from_jax` is the only code of the port that knows the
reference's layout.  The port keeps that layout leaf for leaf (same
nested keys, shapes, dtypes and ``(d_in, d_out)`` weight orientation), so
the conversion is a checked copy: it raises on a missing leaf, an unused
leaf, or a leaf whose shape or dtype is not the port's.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, init_params


def params_from_jax(cfg: ModelConfig, params: Mapping,
                    device: DeviceLike = None) -> Model:
    """The port's :class:`Model` of ``cfg`` holding ``params``, the JAX
    package's parameter pytree (nested dicts of numpy arrays, or anything
    ``np.asarray`` reads), on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    layout = init_params(cfg, None, "meta")
    return Model(cfg, _convert(layout, params, dev, ""))


def _convert(layout: Dict, src: Mapping, dev: torch.device,
             path: str) -> Dict:
    if not isinstance(src, Mapping):
        raise TypeError(f"{path or 'params'}: expected a dict of leaves, "
                        f"got {type(src).__name__}")
    missing = [k for k in layout if k not in src]
    unused = [k for k in src if k not in layout]
    if missing:
        raise KeyError(f"missing leaves {[path + '/' + k for k in missing]}")
    if unused:
        raise KeyError(f"unused leaves {[path + '/' + k for k in unused]}")
    out = {}
    for key, want in layout.items():
        here = f"{path}/{key}"
        if isinstance(want, dict):
            out[key] = _convert(want, src[key], dev, here)
        else:
            out[key] = _leaf(src[key], want, dev, here)
    return out


def _leaf(value, want: torch.Tensor, dev: torch.device,
          path: str) -> torch.Tensor:
    a = np.asarray(value)
    if a.shape != tuple(want.shape):
        raise ValueError(f"{path}: shape {a.shape}, the port's is "
                         f"{tuple(want.shape)}")
    dtype = str(want.dtype).removeprefix("torch.")
    if a.dtype.name != dtype:
        raise ValueError(f"{path}: dtype {a.dtype.name}, the port's is "
                         f"{dtype}")
    if dtype == "bfloat16":   # numpy has no bfloat16 of its own
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)
