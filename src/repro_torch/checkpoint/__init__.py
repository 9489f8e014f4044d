"""Atomic keep-last-k checkpoints (counterpart of :mod:`repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
