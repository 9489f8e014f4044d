"""Optimizers and gradient compression (counterpart of
:mod:`repro.optim`); :mod:`repro_torch.optim.convert` carries the
reference's optimizer states over."""
from repro_torch.optim.optimizers import (
    OptState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    make_optimizer,
)
from repro_torch.optim.grad_compress import compress_grads, decompress_grads

__all__ = [
    "OptState", "adamw_init", "adamw_update", "adafactor_init",
    "adafactor_update", "make_optimizer", "compress_grads",
    "decompress_grads",
]
