"""qwen3-8b — assigned architecture config.

# [dense] qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
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
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
)
