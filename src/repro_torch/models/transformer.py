"""Decoder-only transformer: dense, MoE and VLM-backbone families
(counterpart of :mod:`repro.models.transformer`).

Layer parameters stay stacked with a leading ``L`` axis, as in the
reference; a Python loop over layers takes the place of its ``lax.scan``.
The reference's ``constrain`` calls are the identity without a mesh and
are dropped here (multi-GPU placement is ROADMAP Queue A, item 7).

MoE uses the reference's gather dispatch: per group, a stable sort of the
token-expert assignments gives each its position in its expert; positions
below the capacity are gathered into ``(G, E, C, d)``, run through a
batched expert matmul and scatter-added back.  The kept-slot table
reproduces the reference's overflow rule (ROADMAP caveat R3), computed
instead of relying on the order of duplicate writes: see :func:`moe_route`.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import layers as L
from repro_torch.models.attention import (
    causal_attention,
    decode_attention,
    decode_attention_gqa,
    repeat_kv,
)
from repro_torch.models.config import ModelConfig

F32 = L.F32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.param_dtype)


# ------------------------------------------------------------------ #
# Init
# ------------------------------------------------------------------ #


def init_attn(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.padded_heads, cfg.n_kv_heads
    dt = _dtype(cfg)
    p = {
        "wq": L.dense_init(gen, (n_layers, d, hq * dh), dt, 1, device),
        "wk": L.dense_init(gen, (n_layers, d, hkv * dh), dt, 1, device),
        "wv": L.dense_init(gen, (n_layers, d, hkv * dh), dt, 1, device),
        "wo": L.dense_init(gen, (n_layers, hq * dh, d), dt, 1, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n_layers, dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n_layers, dh), dtype=dt, device=device)
    return p


def init_mlp(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    return {
        "wg": L.dense_init(gen, (n_layers, d, f), dt, 1, device),
        "wu": L.dense_init(gen, (n_layers, d, f), dt, 1, device),
        "wd": L.dense_init(gen, (n_layers, f, d), dt, 1, device),
    }


def init_moe(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    dt = _dtype(cfg)
    return {
        "router": L.dense_init(gen, (n_layers, d, e), F32, 1, device),
        "wg": L.dense_init(gen, (n_layers, e, d, f), dt, 2, device),
        "wu": L.dense_init(gen, (n_layers, e, d, f), dt, 2, device),
        "wd": L.dense_init(gen, (n_layers, e, f, d), dt, 2, device),
    }


def init_params(gen, cfg: ModelConfig, device) -> Dict:
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    dt = _dtype(cfg)
    layers = {
        "attn": init_attn(gen, cfg, n, device),
        "ln1": torch.ones((n, d), dtype=dt, device=device),
        "ln2": torch.ones((n, d), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        layers["moe"] = init_moe(gen, cfg, n, device)
    else:
        layers["mlp"] = init_mlp(gen, cfg, n, device)
    params = {
        "embed": L.embed_init(gen, (v, d), dt, device),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, (d, v), dt, 0, device)
    return params


# ------------------------------------------------------------------ #
# Attention sublayer
# ------------------------------------------------------------------ #


def _project_qkv(p, cfg: ModelConfig, h):
    b, s, _ = h.shape
    dh = cfg.head_dim
    q = L.einsum("bsd,dk->bsk", h, p["wq"]).reshape(
        b, s, cfg.padded_heads, dh)
    k = L.einsum("bsd,dk->bsk", h, p["wk"]).reshape(
        b, s, cfg.n_kv_heads, dh)
    v = L.einsum("bsd,dk->bsk", h, p["wv"]).reshape(
        b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_block(p, cfg: ModelConfig, x, positions,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    k = repeat_kv(k, cfg.n_rep)
    v = repeat_kv(v, cfg.n_rep)
    o = causal_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal)
    return L.einsum("bsk,kd->bsd", o.reshape(b, s, -1), p["wo"])


def _write_cache(cfg: ModelConfig, cache, new, write_at,
                 inplace: bool = False):
    """The cache with ``new`` (B, 1, Hkv, Dh) written at ``write_at`` by the
    reference's three paths: per row (a (B,) vector; positions past the
    cache are dropped), ``onehot`` (a masked select over the sequence; a
    position past the cache writes nothing) and ``dus``
    (``dynamic_update_slice``, whose start is clamped into the cache).
    Out of place, or (``inplace``) into ``cache`` itself, which is
    returned: the same values, written with no copy of the cache and no
    host read of ``write_at``."""
    smax = cache.shape[1]
    if write_at.dim() >= 1:
        at = write_at.reshape(-1)
        rows = torch.arange(cache.shape[0], device=cache.device)
        inside = at < smax
        at = at.clamp(0, smax - 1)
        vals = torch.where(inside[:, None, None], new[:, 0], cache[rows, at])
        if inplace:
            return cache.index_put_((rows, at), vals)
        return cache.index_put((rows, at), vals)
    if cfg.decode_cache_update == "onehot":
        if inplace:
            at = write_at.clamp(0, smax - 1).reshape(1)
            inside = (write_at >= 0) & (write_at < smax)
            vals = torch.where(inside, new, cache.index_select(1, at))
            return cache.index_copy_(1, at, vals)
        sel = torch.arange(smax, device=cache.device) == write_at
        return torch.where(sel[None, :, None, None], new, cache)
    at = write_at.clamp(0, smax - 1).reshape(1)
    if inplace:
        return cache.index_copy_(1, at, new)
    return cache.index_copy(1, at, new)


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, cur_len,
                     inplace: bool = False):
    """One-token attention against the cache; returns (out, new_k, new_v).

    cache_k/v: (B, Smax, Hkv, Dh).  ``cur_len`` is a scalar (every row
    writes and attends at the same position) or a per-row ``(B,)`` vector
    (continuous batching), which always takes the per-row write.  With
    ``inplace`` the new row is written into ``cache_k``/``cache_v``
    themselves (:func:`_write_cache`), which are returned.
    """
    b = x.shape[0]
    write_at = torch.as_tensor(cur_len, device=x.device).long()
    q, k, v = _project_qkv(p, cfg, x)   # (B, 1, H*, Dh)
    if cfg.rope_theta > 0:
        pos = write_at.reshape(-1)[:, None]   # (B|1, 1)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    cache_k = _write_cache(cfg, cache_k, _kv_store(cfg, k, cache_k), write_at,
                           inplace)
    cache_v = _write_cache(cfg, cache_v, _kv_store(cfg, v, cache_v), write_at,
                           inplace)
    ckd = _kv_load(cfg, cache_k)
    cvd = _kv_load(cfg, cache_v)
    if cfg.decode_gqa == "grouped" and cfg.n_rep > 1:
        o = decode_attention_gqa(q, ckd, cvd, write_at + 1)
    else:
        o = decode_attention(q, repeat_kv(ckd, cfg.n_rep),
                             repeat_kv(cvd, cfg.n_rep), write_at + 1)
    out = L.einsum("bsk,kd->bsd", o.reshape(b, 1, -1), p["wo"])
    return out, cache_k, cache_v


# ------------------------------------------------------------------ #
# MoE FFN
# ------------------------------------------------------------------ #


class MoeRoute(NamedTuple):
    """One MoE layer's routing, per token group."""

    gates: torch.Tensor    # (G, T, k) f32, renormalized top-k probabilities
    experts: torch.Tensor  # (G, T, k) int64, top-k experts, best first
    slots: torch.Tensor    # (G, E, C) int64, assignment t*k + j per kept
                           # slot; T*k (the sentinel) where empty


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    return int(max(1, round(cfg.capacity_factor * tokens_per_group
                            * cfg.top_k / cfg.padded_experts)))


def moe_route(p, cfg: ModelConfig, xg: torch.Tensor) -> MoeRoute:
    """Route ``xg`` (G, T, d): top-k by router softmax (ties to the lower
    expert, as ``lax.top_k``), then each assignment's position in its
    expert by a stable sort (``jnp.argsort``) and a left ``searchsorted``.

    Kept slots follow the reference exactly, overflow included (ROADMAP
    caveat R3).  Its dispatch scatter clamps every position to ``C - 1``
    and writes the sentinel there for each dropped assignment, after the
    assignment kept at ``C - 1`` (positions rise with the assignment id):
    an expert with more than ``C`` assignments keeps positions ``< C - 1``
    and leaves slot ``C - 1`` empty; the others keep positions ``< C``.
    Every kept write here has its own slot, so no result depends on the
    order of duplicate writes, which CUDA leaves undefined.
    """
    ng, tg, _ = xg.shape
    e, k = cfg.padded_experts, cfg.top_k
    dev = xg.device
    logits = L.einsum("gtd,de->gte", xg.to(F32), p["router"])
    if e > cfg.n_experts:  # padded experts are unroutable
        pad = torch.arange(e, device=dev) >= cfg.n_experts
        logits = torch.where(pad, -1e30, logits)
    probs, order = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                              descending=True, stable=True)
    gates, topi = probs[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    n = tg * k
    flat_e = topi.reshape(ng, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    ids = torch.arange(e, device=dev).expand(ng, e).contiguous()
    run_start = torch.searchsorted(sorted_e, ids, right=False)   # (G, E)
    run_end = torch.searchsorted(sorted_e, ids, right=True)
    pos_sorted = (torch.arange(n, device=dev)[None, :]
                  - torch.gather(run_start, -1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)

    cap = moe_capacity(cfg, tg)
    overflow = (run_end - run_start) > cap                       # (G, E)
    limit = torch.where(torch.gather(overflow, -1, flat_e), cap - 1, cap)
    keep = pos < limit
    # Kept assignments land in distinct slots; the rest in one spare slot
    # past the table, which is cut off.
    target = torch.where(keep, flat_e * cap + pos, e * cap)
    slots = torch.full((ng, e * cap + 1), n, dtype=torch.long, device=dev)
    slots.scatter_(-1, target,
                   torch.arange(n, device=dev).expand(ng, n).contiguous())
    return MoeRoute(gates, topi, slots[:, :e * cap].reshape(ng, e, cap))


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gather-dispatch MoE.  x: (B, S, d), in ``cfg.moe_groups`` groups."""
    b, s, d = x.shape
    k, ng = cfg.top_k, cfg.moe_groups
    t = b * s
    if t % ng:
        raise ValueError(f"{t} tokens do not split into {ng} MoE groups")
    tg = t // ng
    xg = x.reshape(ng, tg, d)
    route = moe_route(p, cfg, xg)
    e, cap = route.slots.shape[1:]
    sentinel = tg * k
    idx = route.slots.reshape(ng, e * cap)
    valid = idx < sentinel
    tok = torch.clamp(idx, max=sentinel - 1) // k        # token per slot

    groups = torch.arange(ng, device=x.device)[:, None]
    expert_in = xg[groups, tok].reshape(ng, e, cap, d)
    expert_in = torch.where(valid.reshape(ng, e, cap, 1), expert_in, 0.0)
    gg = F.silu(L.einsum("gecd,edf->gecf", expert_in, p["wg"]))
    uu = L.einsum("gecd,edf->gecf", expert_in, p["wu"])
    y = L.einsum("gecf,efd->gecd", gg * uu, p["wd"])   # (G, E, C, d)

    # Combine: scatter-add weighted expert outputs back to token slots.
    w = torch.where(valid, torch.gather(
        route.gates.reshape(ng, sentinel), -1,
        torch.clamp(idx, max=sentinel - 1)), 0.0)
    contrib = y.reshape(ng, e * cap, d) * w[..., None].to(y.dtype)
    target = torch.where(valid, tok, tg)
    out = torch.zeros((ng, tg + 1, d), dtype=contrib.dtype, device=x.device)
    out.scatter_add_(1, target[..., None].expand(ng, e * cap, d), contrib)
    return out[:, :tg].reshape(b, s, d)


# ------------------------------------------------------------------ #
# Layer + model forward
# ------------------------------------------------------------------ #


def _ffn(p, cfg: ModelConfig, h):
    if cfg.family == "moe":
        return moe_ffn(p["moe"], cfg, h)
    return L.swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])


def _layer(p, cfg: ModelConfig, x, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_block(p["attn"], cfg, h, positions)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p, cfg, h)


#: The matrix products ``cfg.remat == "dots"`` keeps (``jnp.einsum``'s
#: ``dot_general`` is what ``dots_with_no_batch_dims_saveable`` saves;
#: ``torch.einsum`` lowers to these).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_call(cfg: ModelConfig, fn: Callable, lp: Dict, *args):
    """``fn(lp, *args)``, one layer's body, under ``cfg.remat`` (the
    reference's ``_maybe_remat``): ``"none"`` calls it; ``"full"`` keeps
    only its inputs and recomputes the rest in the backward pass
    (``nothing_saveable``); ``"dots"`` keeps its matrix products too.
    Remat changes memory, not values, and applies only where gradients
    are taken: with gradients off or frozen parameters it is the plain
    call.  No model draws random numbers, so the RNG state is neither
    saved nor restored.  The checkpoints leave reference cycles behind
    a backward pass, which :class:`repro_torch.graph.CapturedProgram`
    collects before a capture."""
    if (cfg.remat == "none" or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in L.tree_leaves(lp))):
        return fn(lp, *args)
    kw = {"context_fn": _save_dots} if cfg.remat == "dots" else {}
    return checkpoint(fn, lp, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def forward(params, cfg: ModelConfig, x_embed, positions) -> torch.Tensor:
    """Run the layer stack on embedded inputs; returns final hidden."""
    x = x_embed
    for lp in L.layers(params["layers"], cfg.n_layers):
        x = remat_call(cfg, _layer, lp, cfg, x, positions)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def embed(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    return params["embed"][tokens.long()]


def logits_fn(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return L.einsum("bsd,dv->bsv", hidden, head)


def inputs_embedded(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The batch's embeddings (VLM and stub frontends feed them) or its
    tokens' embeddings."""
    if "embeddings" in batch:
        return batch["embeddings"].to(_dtype(cfg))
    return embed(params, cfg, batch["tokens"])


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = inputs_embedded(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    hidden = forward(params, cfg, x, positions)
    logits = logits_fn(params, cfg, hidden)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab_size)


# ------------------------------------------------------------------ #
# Decode (serving)
# ------------------------------------------------------------------ #


KV_INT8_SCALE = 0.05   # fixed quantization step for int8 KV caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    if cfg.kv_cache_dtype == "int8":
        dtype = torch.int8
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_store(cfg: ModelConfig, x, like):
    """Quantize new K/V entries for an int8 cache."""
    if cfg.kv_cache_dtype == "int8":
        return torch.clamp(torch.round(x.to(F32) / KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(like.dtype)


def _kv_load(cfg: ModelConfig, cache):
    if cfg.kv_cache_dtype == "int8":
        return cache.to(torch.bfloat16) * KV_INT8_SCALE
    return cache


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_len,
                inplace: bool = False):
    """One greedy decode step.  tokens: (B, 1) ints (or embeddings
    (B, 1, d) for stub frontends); cur_len: () or (B,) current cache
    length.  Returns (logits, new_cache); with ``inplace`` the new K/V rows
    are written into ``cache``'s own tensors and ``cache`` is returned
    (bit for bit the out-of-place cache; a CUDA graph keeps its buffers)."""
    if tokens.dim() == 3:
        x = tokens.to(_dtype(cfg))
    else:
        x = embed(params, cfg, tokens)
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        att, nk, nv = attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                       cache["v"][i], cur_len, inplace)
        x = x + att
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(lp, cfg, h)
        new_k.append(nk)
        new_v.append(nv)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden)
    if inplace:
        return logits, cache
    return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v)}
