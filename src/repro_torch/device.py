"""Device and dtype policy of the port.

Every entry point resolves its ``device`` argument here: ``None`` means
the CUDA card, and asking for the card where none is present raises
instead of falling back to the CPU.  The simulator and controllers are
float64 end to end, passed explicitly (never via
``torch.get_default_dtype()``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

F64 = torch.float64

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``"cuda"``; raise if a CUDA device is requested and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    """Whether ``a`` and ``b`` name one device, index included; a bare
    ``"cuda"`` is the current card."""
    def whole(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return whole(a) == whole(b)


def as_f64(x, device: Optional[torch.device]) -> torch.Tensor:
    """A float64 tensor on ``device`` (numpy arrays, scalars, tensors)."""
    return torch.as_tensor(x, dtype=F64, device=device)


def lead_tensor(value, lead: tuple, trailing: int, dtype,
                device: Optional[torch.device]) -> torch.Tensor:
    """A scalar or per-row tunable as a tensor that broadcasts against
    state with ``lead`` leading axes and ``trailing`` more: shape ``lead +
    (1,) * trailing``, or 0-D for a scalar."""
    t = torch.as_tensor(np.asarray(value), dtype=dtype, device=device)
    return t if t.dim() == 0 else t.reshape(lead + (1,) * trailing)
