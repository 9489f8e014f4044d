"""Decoder-only transformer: dense, MoE and VLM-backbone families
(counterpart of :mod:`repro.models.transformer`).

Layer parameters stay stacked with a leading ``L`` axis, as in the
reference; a Python loop over layers takes the place of its ``lax.scan``.
Activations are pinned with ``constrain`` where the reference pins them:
the identity without a mesh, a redistribution of a DTensor under one
(:mod:`repro_torch.distributed`).

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

from repro_torch.distributed import (
    constrain,
    get_dp_axes,
    get_mesh,
    is_dtensor,
    mesh_axes,
    on_shards,
    placements,
    spec,
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
    q = L.reshape(L.einsum("bsd,dk->bsk", h, p["wq"]),
                  b, s, cfg.padded_heads, dh)
    k = L.reshape(L.einsum("bsd,dk->bsk", h, p["wk"]),
                  b, s, cfg.n_kv_heads, dh)
    v = L.reshape(L.einsum("bsd,dk->bsk", h, p["wv"]),
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
    hq = "model" if cfg.heads_shardable else None
    q = constrain(q, "dp", None, hq, None)
    k = repeat_kv(k, cfg.n_rep)
    v = repeat_kv(v, cfg.n_rep)
    o = causal_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal)
    o = constrain(o, "dp", None, hq, None)
    return L.einsum("bsk,kd->bsd", L.reshape(o, b, s, -1), p["wo"])


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


def _decode_batch_axis(b: int):
    """"dp" where the DP axes of the ambient mesh divide the batch ``b``,
    else None (and None without a mesh)."""
    mesh = get_mesh()
    if mesh is None:
        return None
    names, sizes = mesh_axes(mesh)
    dp_n = 1
    for a in get_dp_axes():
        if a in names:
            dp_n *= sizes[a]
    return "dp" if b % dp_n == 0 and b >= dp_n else None


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
    # Pin the ring-buffer layout (batch over DP when divisible, sequence
    # over model), and keep the one-token query replicated over "model"
    # (split-KV decode).
    if not cfg.pure_dp:
        bax = _decode_batch_axis(cache_k.shape[0])
        cache_k = constrain(cache_k, bax, "model", None, None)
        cache_v = constrain(cache_v, bax, "model", None, None)
        q = constrain(q, bax, None, None, None)
    ckd = _kv_load(cfg, cache_k)
    cvd = _kv_load(cfg, cache_v)
    if cfg.decode_gqa == "grouped" and cfg.n_rep > 1:
        o = decode_attention_gqa(q, ckd, cvd, write_at + 1)
    else:
        o = decode_attention(q, repeat_kv(ckd, cfg.n_rep),
                             repeat_kv(cvd, cfg.n_rep), write_at + 1)
    if not cfg.pure_dp:
        o = constrain(o, bax, None, None, None)
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

    flat_e = topi.reshape(ng, tg * k)
    cap = moe_capacity(cfg, tg)
    if is_dtensor(flat_e):
        # searchsorted has no DTensor rule; the slots of a group depend on
        # that group's assignments alone, and the groups are split over
        # the DP axes only, so each rank computes its own groups'.
        pl = flat_e.placements
        slots = on_shards(_kept_slots, flat_e.device_mesh, (pl,),
                          (pl, None, None))(flat_e, e, cap)
    else:
        slots = _kept_slots(flat_e, e, cap)
    return MoeRoute(gates, topi, slots)


def _kept_slots(flat_e: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """The (G, E, C) kept-slot table of :class:`MoeRoute` from each
    group's flat assignments ``flat_e`` (G, T*k): a stable sort gives each
    assignment its position in its expert, and the overflow rule of
    :func:`moe_route` keeps the slots."""
    ng, n = flat_e.shape
    dev = flat_e.device
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    ids = torch.arange(e, device=dev).expand(ng, e).contiguous()
    run_start = torch.searchsorted(sorted_e, ids, right=False)   # (G, E)
    run_end = torch.searchsorted(sorted_e, ids, right=True)
    pos_sorted = (torch.arange(n, device=dev)[None, :]
                  - torch.gather(run_start, -1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)

    overflow = (run_end - run_start) > cap                       # (G, E)
    limit = torch.where(torch.gather(overflow, -1, flat_e), cap - 1, cap)
    keep = pos < limit
    # Kept assignments land in distinct slots; the rest in one spare slot
    # past the table, which is cut off.
    target = torch.where(keep, flat_e * cap + pos, e * cap)
    slots = torch.full((ng, e * cap + 1), n, dtype=torch.long, device=dev)
    slots.scatter_(-1, target,
                   torch.arange(n, device=dev).expand(ng, n).contiguous())
    return slots[:, :e * cap].reshape(ng, e, cap)


def _dispatch(xg: torch.Tensor, slots: torch.Tensor, k: int) -> torch.Tensor:
    """Each kept slot's token, (G, E, C, d) from ``xg`` (G, T, d); an empty
    slot holds zeros."""
    ng, e, cap = slots.shape
    sentinel = xg.shape[1] * k
    tok = torch.clamp(slots, max=sentinel - 1) // k      # token per slot
    groups = torch.arange(ng, device=xg.device)[:, None, None]
    return torch.where((slots < sentinel)[..., None], xg[groups, tok], 0.0)


def _combine(y: torch.Tensor, gates: torch.Tensor, slots: torch.Tensor,
             tg: int, k: int) -> torch.Tensor:
    """Scatter-add the gated expert outputs ``y`` (G, E, C, d) back to
    their tokens: (G, tg, d)."""
    ng, e, cap, d = y.shape
    sentinel = tg * k
    idx = slots.reshape(ng, e * cap)
    valid = idx < sentinel
    clamped = torch.clamp(idx, max=sentinel - 1)
    w = torch.where(valid, torch.gather(gates.reshape(ng, sentinel), -1,
                                        clamped), 0.0)
    contrib = y.reshape(ng, e * cap, d) * w[..., None].to(y.dtype)
    target = torch.where(valid, clamped // k, tg)
    out = torch.zeros((ng, tg + 1, d), dtype=contrib.dtype, device=y.device)
    out.scatter_add_(1, target[..., None].expand(ng, e * cap, d), contrib)
    return out[:, :tg]


def _moe_local_fns(xg, espec):
    """:func:`_dispatch` and :func:`_combine`, each over its own groups and
    experts on every rank under a mesh.  Groups are split over the DP axes
    and experts over ``espec``'s; a rank gathers and scatters only the
    slots of its experts, so the combine is a partial sum over the expert
    axes (reduced by the next ``constrain``) and so are the gradients of
    the tokens and gates."""
    if not is_dtensor(xg):
        return _dispatch, _combine
    from torch.distributed.tensor import Partial

    mesh = xg.device_mesh
    grp = list(xg.placements)                            # (G, ...) tensors
    exp = placements(spec("dp", espec, None, None, mesh=get_mesh()), mesh)
    part = [Partial() if e.is_shard(1) else g for e, g in zip(exp, grp)]
    dispatch = on_shards(_dispatch, mesh, (exp,), (grp, exp, None),
                         (part, exp, None))
    combine = on_shards(_combine, mesh, (part,),
                        (exp, grp, exp, None, None),
                        (exp, part, exp, None, None))
    return dispatch, combine


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gather-dispatch MoE.  x: (B, S, d), in ``cfg.moe_groups`` groups."""
    b, s, d = x.shape
    k, ng = cfg.top_k, cfg.moe_groups
    t = b * s
    if t % ng:
        raise ValueError(f"{t} tokens do not split into {ng} MoE groups")
    tg = t // ng
    if is_dtensor(x):
        # tokens data-sharded only before the grouping reshape: DTensor
        # cannot fold a sequence split over "model" into the groups
        x = constrain(x, "dp", None, None)
    xg = constrain(L.reshape(x, ng, tg, d), "dp", None, None)
    route = moe_route(p, cfg, xg)
    espec = "model" if cfg.moe_ep else None
    dispatch, combine = _moe_local_fns(xg, espec)
    slots = constrain(route.slots, "dp", espec, None)
    # (a redistribution's backward brings the gradient back to the layout
    # it came from: the pins of xg and the gates here sum the expert
    # axes' partial gradients of the dispatch and the combine)
    expert_in = constrain(dispatch(constrain(xg, "dp", None, None), slots, k),
                          "dp", espec, None, None)

    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    if cfg.moe_gather_weights and not cfg.moe_ep:
        # FSDP experts: gather the weights' d dim before the products
        wg = constrain(wg, espec, None, "model")
        wu = constrain(wu, espec, None, "model")
        wd = constrain(wd, espec, "model", None)
    gg = F.silu(L.einsum("gecd,edf->gecf", expert_in, wg))
    uu = L.einsum("gecd,edf->gecf", expert_in, wu)
    y = L.einsum("gecf,efd->gecd", gg * uu, wd)   # (G, E, C, d)
    y = constrain(y, "dp", espec, None, None)

    gates = constrain(route.gates, "dp", None, None)
    out = constrain(combine(y, gates, slots, tg, k), "dp", None, None)
    return L.reshape(out, b, s, d)


# ------------------------------------------------------------------ #
# Layer + model forward
# ------------------------------------------------------------------ #


def _ffn(p, cfg: ModelConfig, h):
    if cfg.family == "moe":
        return moe_ffn(p["moe"], cfg, h)
    return L.swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])


def _seq_axis(cfg: ModelConfig):
    """The residual stream's sequence axis: "model" under sequence-sharded
    activations (Megatron-SP), else None."""
    return "model" if cfg.seq_shard_activations else None


def _layer(p, cfg: ModelConfig, x, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_block(p["attn"], cfg, h, positions)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _ffn(p, cfg, h)
    return constrain(x, "dp", _seq_axis(cfg), None)


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
    x = constrain(x_embed, "dp", _seq_axis(cfg), None)
    for lp in L.layers(params["layers"], cfg.n_layers):
        x = remat_call(cfg, _layer, lp, cfg, x, positions)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def embed(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    table = params["embed"]
    if is_dtensor(table):
        return _embed_on_shards(table, tokens)
    return table[tokens.long()]


def _embed_on_shards(table: torch.Tensor, tokens) -> torch.Tensor:
    """The lookup of a DTensor table (V, d): each rank gathers its own
    tokens' rows of its own columns (the reference shards d, so the
    gather stays local); a mesh axis that splits the vocabulary, or both
    the tokens and the columns, is gathered first.  The table's gradient
    is a partial sum over the axes that split the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(tokens):      # the same on every rank
        tokens = DTensor.from_local(torch.as_tensor(tokens), mesh,
                                    [Replicate()] * mesh.ndim)
    tok = list(tokens.placements)
    tab = [p if p.is_shard(1) and not t.is_shard() else Replicate()
           for p, t in zip(table.placements, tok)]
    table = table.redistribute(mesh, tab)
    nd = tokens.dim()
    out = [t if t.is_shard() else Shard(nd) if p.is_shard(1) else Replicate()
           for p, t in zip(tab, tok)]
    grad = [Partial() if t.is_shard() else p for p, t in zip(tab, tok)]
    return on_shards(lambda tb, tk: tb[tk.long()], mesh, (out,),
                     (tab, tok), (grad, tok))(table, tokens)


def logits_fn(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    out = L.einsum("bsd,dv->bsv", hidden, head)
    return constrain(out, "dp", None, "model")


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
