"""yi-34b — assigned architecture config.

# [dense] llama-arch GQA; 56 q-heads pad to 64 on a 16-way model axis
# (DESIGN.md 4) [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
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
