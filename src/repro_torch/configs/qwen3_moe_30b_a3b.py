"""qwen3-moe-30b-a3b — assigned architecture config.

# [moe] 128 experts top-8, expert d_ff=768 [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
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
    d_ff=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    n_experts=8,
    top_k=2,
)
