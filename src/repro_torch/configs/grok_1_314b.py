"""grok-1-314b — assigned architecture config.

# [moe] 8 experts top-2 (padded to 16 for the 16-way model axis)
# [hf:xai-org/grok-1; unverified]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
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
    d_ff=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    n_experts=8,
    top_k=2,
)
