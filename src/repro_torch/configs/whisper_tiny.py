"""whisper-tiny — assigned architecture config.

# [audio] enc-dec backbone, conv frontend STUBBED (precomputed frame
# embeddings) [arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    rope_theta=0.0,
    frontend='audio',
    tie_embeddings=True,
    pure_dp=True,
    seq_shard_activations=False,
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
    n_kv_heads=4,
    d_head=16,
    n_enc_layers=2,
)
