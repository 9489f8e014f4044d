"""mamba2-1.3b — assigned architecture config.

# [ssm] SSD (state-space duality), attn-free [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    rope_theta=0.0,
)

# Reduced same-family smoke config: tiny widths/depths, one CPU train step.
SMOKE = dataclasses.replace(
    CONFIG,
    param_dtype='float32',
    remat='none',
    attn_chunk=64,
    seq_shard_activations=False,
    vocab_size=512,
    d_model=64,
    d_ff=0,
    n_layers=2,
    ssm_state=16,
    ssm_chunk=16,
)
