"""zamba2-7b — assigned architecture config.

# [hybrid] Mamba2 backbone + shared attention block every 6 layers
# [arXiv:2411.15242; unverified]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
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
    d_ff=128,
    n_layers=5,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    ssm_state=16,
    ssm_chunk=16,
    attn_every=2,
)
