"""Analytic per-device memory model, arithmetic only (a copy of
:mod:`repro.launch.analytic` over the port's
:class:`~repro_torch.models.model.ShapeSpec`): what a config needs on each
device, before anything is built."""
from __future__ import annotations

from typing import Dict


def analytic_memory(cfg, spec, chips: int, optimizer: str) -> Dict:
    """Per-device residency in bytes: bf16 parameters (split over the
    model axis unless ``cfg.pure_dp``), and for a ``train`` shape the f32
    optimizer state (AdamW: master + m + v, 12 bytes a parameter; else
    master + factored moments, 4.2) split over every chip (ZeRO-1 over
    data x model) and bf16 gradients split over the model axis; for a
    ``decode`` shape the KV cache and SSM state split over every chip."""
    n = cfg.param_count()
    mdl = max(cfg.mesh_model, 1)
    params_b = 2.0 * n / (mdl if not cfg.pure_dp else chips // 1)
    if cfg.pure_dp:
        params_b = 2.0 * n  # replicated
    out = {"params_bytes": params_b}
    if spec.kind == "train":
        if optimizer == "adamw":
            opt = 12.0 * n            # f32 master+m+v
        else:
            opt = 4.2 * n             # f32 master + factored moments
        out["opt_bytes"] = opt / chips  # ZeRO-1 over data x model
        out["grads_bytes"] = 2.0 * n / mdl
    if spec.kind == "decode":
        sites = cfg.n_layers
        if cfg.family == "hybrid":
            sites = (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every
        kv = 0.0
        if cfg.family not in ("ssm",):
            kv = (2.0 * sites * spec.global_batch * spec.seq_len
                  * cfg.n_kv_heads * cfg.head_dim * 2.0)
            if cfg.family == "encdec":
                kv *= 2.0  # cross-attention K/V
        state = 0.0
        if cfg.family in ("ssm", "hybrid"):
            state = (4.0 * cfg.n_layers * spec.global_batch
                     * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                        + (cfg.ssm_conv - 1) * cfg.d_inner))
        out["kv_cache_bytes"] = (kv + state) / chips
    out["total_bytes"] = float(sum(out.values()))
    return out
