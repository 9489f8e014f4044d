"""Model configuration shared by every architecture family (a copy of
:mod:`repro.models.config`: the same fields, derived properties and
parameter counts, so that a config names the same model in both
packages)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # Hybrid (zamba2-style): shared attention block applied every k layers
    attn_every: int = 0

    # Enc-dec (whisper): n_layers == decoder layers
    n_enc_layers: int = 0

    # Modality frontend stub: "none" | "audio" | "patch"
    frontend: str = "none"

    # Numerics / distribution
    param_dtype: str = "bfloat16"
    remat: str = "full"            # none | full | dots
    attn_chunk: int = 1024
    seq_shard_activations: bool = True   # Megatron-SP-style residual shard
    mesh_model: int = 1            # model-axis size padding is computed for
    moe_groups: int = 1            # MoE dispatch groups (= DP size so the
                                   # token gather/scatter stays shard-local)
    pure_dp: bool = False          # tiny models: use the model axis as extra
                                   # DP instead of TP (whisper-tiny)
    decode_cache_update: str = "onehot"  # "dus" | "onehot" (§Perf C1/C3)
    decode_gqa: str = "grouped"        # "repeat" | "grouped" (§Perf C4)
    moe_gather_weights: bool = False   # TPxFSDP experts: gather weights
                                       # before the einsum (AG weights once
                                       # instead of AR partial activations)
    kv_cache_dtype: str = "bfloat16"   # "bfloat16" | "int8" (quantized KV)

    # ----- derived ----------------------------------------------------- #

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_heads(self) -> int:
        """Query heads padded up to a multiple of the model axis (yi-34b:
        56 -> 64) when head-sharding is used at all."""
        m = self.mesh_model
        if m <= 1 or self.n_heads % m == 0:
            return self.n_heads
        if self.n_heads >= m:
            return _ceil_to(self.n_heads, m)
        return self.n_heads  # tiny models: attention stays replicated

    @property
    def heads_shardable(self) -> bool:
        return self.mesh_model > 1 and self.padded_heads % self.mesh_model == 0

    @property
    def padded_experts(self) -> int:
        m = self.mesh_model
        if self.n_experts == 0 or m <= 1 or self.n_experts < m:
            return self.n_experts     # few-big-experts: TPxFSDP, no padding
        return _ceil_to(self.n_experts, m)

    @property
    def moe_ep(self) -> bool:
        """Experts shardable over the model axis (EP); otherwise the
        expert FFN weights shard d_ff over model (TP) and d over data
        (FSDP) — the grok-1 layout (8 huge experts on a 16-way axis)."""
        m = self.mesh_model
        return m <= 1 or (self.padded_experts % m == 0
                          and self.padded_experts >= m)

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_rep(self) -> int:
        return self.padded_heads // self.n_kv_heads

    def with_mesh(self, mesh_model: int, dp: int = 1) -> "ModelConfig":
        return dataclasses.replace(
            self, mesh_model=mesh_model,
            moe_groups=dp if self.n_experts else 1)

    def param_count(self) -> int:
        """Exact parameter count (excluding padding), for MODEL_FLOPS."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.qk_norm:
            attn += 2 * dh
        mlp = 3 * d * f
        norms = 2 * d
        total = 0
        if self.family in ("dense", "vlm"):
            total = L * (attn + mlp + norms)
        elif self.family == "moe":
            moe = 3 * d * f * self.n_experts + d * self.n_experts
            total = L * (attn + moe + norms)
        elif self.family == "ssm":
            total = L * self._mamba_block_params()
        elif self.family == "hybrid":
            total = L * self._mamba_block_params() + (attn + mlp + norms)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp + norms)
            dec = L * (2 * attn + mlp + 3 * d)
            total = enc + dec
        total += v * d            # embedding
        if not self.tie_embeddings:
            total += d * v        # head
        total += d                # final norm
        return total

    def _mamba_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        n, hh = self.ssm_state, self.ssm_heads
        # in projections (z, x, B, C, dt) + conv + A/D + gated norm + out
        return (d * (2 * di + 2 * n + hh) + di * self.ssm_conv
                + 2 * hh + di + di * d + d)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense_part = self.param_count() - L * 3 * d * f * self.n_experts
        return dense_part + L * 3 * d * f * self.top_k
