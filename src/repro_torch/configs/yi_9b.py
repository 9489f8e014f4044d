"""yi-9b — assigned architecture config.

# [dense] llama-arch GQA [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=11008,
    vocab_size=64000,
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
