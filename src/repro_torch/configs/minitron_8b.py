"""minitron-8b — assigned architecture config.

# [dense] pruned nemotron, 256k vocab [arXiv:2407.14679; hf]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=256000,
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
