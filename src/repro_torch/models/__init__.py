"""Architecture families in PyTorch (counterpart of :mod:`repro.models`):
dense/MoE/VLM decoders, Mamba2 SSD, the Zamba2 hybrid and the Whisper
encoder-decoder, each with loss, prefill and cached decode.  Plain
PyTorch ops, as the reference's jnp paths: no hand-written kernel runs in
a model."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import SHAPES, Model, ShapeSpec, build

__all__ = ["ModelConfig", "Model", "ShapeSpec", "SHAPES", "build",
           "params_from_jax"]
