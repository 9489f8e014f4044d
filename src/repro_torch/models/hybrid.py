"""Zamba2-style hybrid: Mamba2 backbone + a *shared* attention block
(arXiv:2411.15242) applied every ``attn_every`` layers (counterpart of
:mod:`repro.models.hybrid`).

One set of attention+MLP weights is reused at every application site;
per-site LoRA deltas are omitted, as in the reference.  The shared block
runs before layers ``0, attn_every, 2 * attn_every, ...``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import constrain
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def init_params(gen, cfg: ModelConfig, device) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    dt = L.torch_dtype(cfg.param_dtype)
    shared = {
        "attn": L.layer(T.init_attn(gen, cfg, 1, device), 0),
        "mlp": L.layer(T.init_mlp(gen, cfg, 1, device), 0),
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
    }
    return {
        "embed": L.embed_init(gen, (v, d), dt, device),
        "layers": S.init_mamba(gen, cfg, cfg.n_layers, device),
        "shared": shared,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "head": L.dense_init(gen, (d, v), dt, 0, device),
    }


def _shared_block(shared, cfg: ModelConfig, x, positions):
    h = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
    x = x + T.attention_block(shared["attn"], cfg, h, positions)
    h = L.rms_norm(x, shared["ln2"], cfg.norm_eps)
    return x + L.swiglu(h, shared["mlp"]["wg"], shared["mlp"]["wu"],
                        shared["mlp"]["wd"])


def _hybrid_layer(lp, cfg: ModelConfig, x, positions, shared, attend: bool):
    """One remat unit, as the reference's scan body: the shared block
    where it applies, then the layer's Mamba block."""
    if attend:
        x = _shared_block(shared, cfg, x, positions)
    return constrain(S.mamba_block(lp, cfg, x), "dp", T._seq_axis(cfg), None)


def forward(params, cfg: ModelConfig, x, positions) -> torch.Tensor:
    every = max(cfg.attn_every, 1)
    for i, lp in enumerate(L.layers(params["layers"], cfg.n_layers)):
        x = T.remat_call(cfg, _hybrid_layer, lp, cfg, x, positions,
                         params["shared"], i % every == 0)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = T.embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    hidden = forward(params, cfg, x, positions)
    logits = T.logits_fn(params, cfg, hidden)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab_size)


def n_attn_sites(cfg: ModelConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // max(cfg.attn_every, 1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    sites = n_attn_sites(cfg)
    cache = S.init_ssm_cache(cfg, batch, cfg.n_layers, device=device)
    shape = (sites, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_len,
                inplace: bool = False):
    """One-token step, site by site: the shared block against the site's
    K/V cache, then the site's Mamba layers.  The reference pads the
    Mamba stack to ``sites * attn_every`` layers and masks the padding
    out; a loop over the real layers computes the same, with the cache's
    ``conv``/``state`` in ``n_layers`` rows and ``k``/``v`` in ``sites``.
    With ``inplace`` every new row goes into ``cache``'s own tensors and
    ``cache`` is returned."""
    x = T.embed(params, cfg, tokens)
    shared = params["shared"]
    every = cfg.attn_every
    convs, states, ks, vs = [], [], [], []
    for site in range(n_attn_sites(cfg)):
        h = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
        att, nk, nv = T.attention_decode(shared["attn"], cfg, h,
                                         cache["k"][site], cache["v"][site],
                                         cur_len, inplace)
        x = x + att
        h = L.rms_norm(x, shared["ln2"], cfg.norm_eps)
        x = x + L.swiglu(h, shared["mlp"]["wg"], shared["mlp"]["wu"],
                         shared["mlp"]["wd"])
        ks.append(nk)
        vs.append(nv)
        for i in range(site * every, min((site + 1) * every, cfg.n_layers)):
            x, nc, ns = S.mamba_decode(L.layer(params["layers"], i), cfg, x,
                                       cache["conv"][i], cache["state"][i])
            if inplace:
                cache["conv"][i].copy_(nc)
                cache["state"][i].copy_(ns)
            convs.append(nc)
            states.append(ns)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.logits_fn(params, cfg, hidden)
    if inplace:
        return logits, cache
    return logits, {"conv": torch.stack(convs), "state": torch.stack(states),
                    "k": torch.stack(ks), "v": torch.stack(vs)}
