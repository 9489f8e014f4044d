"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; counterpart
of :mod:`repro.models.encdec`).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  Encoder: non-causal
self-attention + GELU MLP with sinusoidal positions.  Decoder: causal
self-attention + cross-attention + GELU MLP.  RMSNorm replaces LayerNorm
and biases are omitted, as in the reference.

The decode step adds position 0's sinusoid at every step, as the
reference's does ("position enc simplified"); so its logits equal the
teacher-forced decoder's at position 0 only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import (
    causal_attention,
    decode_attention,
    repeat_kv,
)
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.param_dtype)


def _init_xattn(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    p = T.init_attn(gen, cfg, n_layers, device)
    p.pop("q_norm", None)
    p.pop("k_norm", None)
    return p


def _init_gelu_mlp(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    return {
        "wi": L.dense_init(gen, (n_layers, d, f), dt, 1, device),
        "wo": L.dense_init(gen, (n_layers, f, d), dt, 1, device),
    }


def init_params(gen, cfg: ModelConfig, device) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    dt = _dtype(cfg)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = {
        "attn": _init_xattn(gen, cfg, ne, device),
        "mlp": _init_gelu_mlp(gen, cfg, ne, device),
        "ln1": ones(ne, d),
        "ln2": ones(ne, d),
    }
    dec = {
        "attn": _init_xattn(gen, cfg, nd, device),
        "xattn": _init_xattn(gen, cfg, nd, device),
        "mlp": _init_gelu_mlp(gen, cfg, nd, device),
        "ln1": ones(nd, d),
        "lnx": ones(nd, d),
        "ln2": ones(nd, d),
    }
    return {
        "encoder": enc,
        "decoder": dec,
        "embed": L.embed_init(gen, (v, d), dt, device),
        "enc_norm": ones(d),
        "final_norm": ones(d),
        "head": L.dense_init(gen, (d, v), dt, 0, device),
    }


def _mha(p, cfg: ModelConfig, xq, xkv, causal: bool):
    b, sq, _ = xq.shape
    dh = cfg.head_dim
    q = L.einsum("bsd,dk->bsk", xq, p["wq"]).reshape(
        b, sq, cfg.padded_heads, dh)
    k, v = _project_kv(p, cfg, xkv)
    k = repeat_kv(k, cfg.n_rep)
    v = repeat_kv(v, cfg.n_rep)
    o = causal_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal)
    return L.einsum("bsk,kd->bsd", o.reshape(b, sq, -1), p["wo"])


def _project_kv(p, cfg: ModelConfig, xkv):
    b, s, _ = xkv.shape
    shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
    return (L.einsum("bsd,dk->bsk", xkv, p["wk"]).reshape(shape),
            L.einsum("bsd,dk->bsk", xkv, p["wv"]).reshape(shape))


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder hidden."""
    pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device)
    x = frames + pos[None].to(frames.dtype)
    for lp in L.layers(params["encoder"], cfg.n_enc_layers):
        x = T.remat_call(cfg, _encoder_layer, lp, cfg, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encoder_layer(lp, cfg: ModelConfig, x):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _mha(lp["attn"], cfg, h, h, causal=False)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.gelu_mlp(h, lp["mlp"]["wi"], lp["mlp"]["wo"])


def _decoder_layer(lp, cfg: ModelConfig, x, enc_hidden):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _mha(lp["attn"], cfg, h, h, causal=True)
    h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
    x = x + _mha(lp["xattn"], cfg, h, enc_hidden, causal=False)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.gelu_mlp(h, lp["mlp"]["wi"], lp["mlp"]["wo"])


def decode_train(params, cfg: ModelConfig, tokens,
                 enc_hidden) -> torch.Tensor:
    x = T.embed(params, cfg, tokens)
    pos = L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
    x = x + pos[None].to(x.dtype)
    for lp in L.layers(params["decoder"], cfg.n_layers):
        x = T.remat_call(cfg, _decoder_layer, lp, cfg, x, enc_hidden)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    enc_hidden = encode(params, cfg, batch["frames"].to(_dtype(cfg)))
    hidden = decode_train(params, cfg, batch["tokens"], enc_hidden)
    logits = T.logits_fn(params, cfg, hidden)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab_size)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=device)

    # Cross-attention K/V are computed once from the encoder output
    # (:func:`cross_kv`); ``enc_len`` is how many of their positions hold.
    return {"k": zeros(), "v": zeros(), "xk": zeros(), "xv": zeros(),
            "enc_len": torch.zeros((), dtype=torch.int32, device=device)}


def cross_kv(params, cfg: ModelConfig,
             enc_hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K and V of the encoder hidden,
    stacked (n_layers, B, S_enc, Hkv, Dh): what the cache's ``xk``/``xv``
    hold in their first ``S_enc`` positions (the reference fills them so in
    ``tests/test_models_smoke.py::test_decode_step_shapes``)."""
    ks, vs = zip(*(_project_kv(L.layer(params["decoder"], i)["xattn"], cfg,
                               enc_hidden) for i in range(cfg.n_layers)))
    return torch.stack(ks), torch.stack(vs)


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_len,
                inplace: bool = False):
    """One-token step; with ``inplace`` the self-attention K/V rows are
    written into ``cache``'s own tensors and ``cache`` is returned."""
    x = T.embed(params, cfg, tokens)
    pos = L.sinusoidal_positions(1, cfg.d_model, x.device)  # simplified
    x = x + pos[None].to(x.dtype)
    enc_len = cache["enc_len"]
    b, dh = x.shape[0], cfg.head_dim
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        lp = L.layer(params["decoder"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        att, nk, nv = T.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                         cache["v"][i], cur_len, inplace)
        x = x + att
        h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
        q = L.einsum("bsd,dk->bsk", h, lp["xattn"]["wq"]).reshape(
            b, 1, cfg.padded_heads, dh)
        o = decode_attention(q, repeat_kv(cache["xk"][i], cfg.n_rep),
                             repeat_kv(cache["xv"][i], cfg.n_rep), enc_len)
        x = x + L.einsum("bsk,kd->bsd", o.reshape(b, 1, -1),
                         lp["xattn"]["wo"])
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.gelu_mlp(h, lp["mlp"]["wi"], lp["mlp"]["wo"])
        new_k.append(nk)
        new_v.append(nv)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.logits_fn(params, cfg, hidden)
    if inplace:
        return logits, cache
    new_cache = dict(cache)
    new_cache["k"] = torch.stack(new_k)
    new_cache["v"] = torch.stack(new_v)
    return logits, new_cache
