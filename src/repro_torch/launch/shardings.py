"""Specs for parameters, optimizer state, caches and batches, and their
placement on a mesh (counterpart of :mod:`repro.launch.shardings`).

A spec is the reference's ``PartitionSpec`` as a tuple
(:data:`repro_torch.distributed.Spec`); trees are the port's nested
dicts, and a leaf's name is the last key of its path.  The rules are the
reference's, leaf-name based and rank-aware, so one table covers stacked
``(L, ...)`` and unstacked (the hybrid's shared block) parameters:

  wq / wg / wu / wi / wx / wz / wdt  -> shard LAST dim over "model"
        (query heads / d_ff / ssm channels; column-parallel)
  wo / wd / out                      -> shard dim -2 over "model"
        (row-parallel: contraction dim sharded, output partial-summed)
  wk / wv / router / norms / biases  -> replicated (GQA KV replication)
  moe wg/wu/wd (rank 4)              -> shard EXPERT dim over "model" (EP)
  embed (V, d)                       -> shard d (gather stays local)
  head (d, V)                        -> shard V (vocab-parallel logits)
  A_log / D / dt_bias / norm (rank 2)-> shard last (ssm heads/channels)

Batches shard over the DP axes; decode KV caches shard the *sequence* dim
over "model" (split-KV decode) and SSM states shard heads.  The specs read
only a mesh's axis names and sizes (:func:`repro_torch.distributed.
mesh_axes`), and leaves only for their shapes: a full config's layout
comes from ``init_params(cfg, None, "meta")`` without allocating.
:func:`place` puts a tree on a :class:`DeviceMesh` by its specs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.distributed import P, Spec, is_dtensor, mesh_axes, placements
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.optim.optimizers import OptState

LAST = {"wg", "wu", "wi", "wx", "wz", "wdt", "embed"}
ROW = {"wo", "wd", "out"}
REPL = {"wk", "wv", "router", "ln", "ln1", "ln2", "lnx", "q_norm",
        "k_norm", "final_norm", "enc_norm", "dt_bias_repl"}
VEC_LAST = {"A_log", "D", "dt_bias", "norm", "conv"}


def dp_axes_for(cfg: ModelConfig):
    if cfg.pure_dp:
        return ("pod", "data", "model")
    return ("pod", "data")


def _dp(mesh, cfg: Optional[ModelConfig] = None) -> Optional[tuple]:
    wanted = dp_axes_for(cfg) if cfg is not None else ("pod", "data")
    axes = tuple(a for a in wanted if a in mesh_axes(mesh)[0])
    return axes if axes else None


def _mdl(mesh) -> Optional[str]:
    return "model" if "model" in mesh_axes(mesh)[0] else None


def _with_paths(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, the path its keys."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_spec_for(path: tuple, leaf, cfg: ModelConfig, mesh) -> Spec:
    name = next((e for e in reversed(path) if isinstance(e, str)), None)
    m = _mdl(mesh)
    rank = len(leaf.shape)
    if m is None or cfg.pure_dp:
        return P(*([None] * rank))
    heads_ok = cfg.heads_shardable

    if name == "wq":
        return P(*([None] * (rank - 1)), m if heads_ok else None)
    if name == "wo":
        sp = [None] * rank
        if heads_ok:
            sp[rank - 2] = m
        return P(*sp)
    if name in ("wk", "wv"):
        return P(*([None] * rank))
    if name in ("wg", "wu", "wd") and rank == 4:   # MoE experts
        if cfg.moe_ep:
            return P(None, m, None, None)          # EP over experts
        dat = "data" if "data" in mesh_axes(mesh)[0] else None
        if name == "wd":                           # (L, E, f, d)
            return P(None, None, m, dat)
        return P(None, None, dat, m)               # TP(f) x FSDP(d)
    if name in LAST:
        if name == "embed":
            return P(None, m)  # (V, d): shard d -> local gather
        return P(*([None] * (rank - 1)), m)
    if name in ROW:
        sp = [None] * rank
        sp[rank - 2] = m
        return P(*sp)
    if name == "head":
        return P(None, m)
    if name in VEC_LAST:
        if name == "conv":                          # (L, di, K)
            sp = [None] * rank
            sp[rank - 2] = m
            return P(*sp)
        if name == "norm" and rank >= 2:            # (L, di)
            return P(*([None] * (rank - 1)), m)
        if name in ("A_log", "D", "dt_bias") and rank >= 1:
            return P(*([None] * (rank - 1)), m)
    return P(*([None] * rank))


def _validated(sp: Spec, leaf, mesh) -> Spec:
    """Drop axes whose mesh size does not divide the dim (reduced smoke
    configs and odd-sized meshes)."""
    sizes = mesh_axes(mesh)[1]
    out = []
    for i, entry in enumerate(sp):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        dim = leaf.shape[i] if i < len(leaf.shape) else 0
        out.append(entry if dim % n == 0 and dim >= n else None)
    return P(*out)


def param_specs(cfg: ModelConfig, params_shape, mesh):
    return _with_paths(
        lambda path, leaf: _validated(
            param_spec_for(path, leaf, cfg, mesh), leaf, mesh),
        params_shape)


def _zero1(pspec: Spec, leaf, mesh) -> Spec:
    """ZeRO-1: also shard optimizer state over the "data" axis on the
    largest unsharded dim that divides (the update is elementwise, so any
    layout is local; the only cost is the per-step master->param
    all-gather over "data")."""
    names, sizes = mesh_axes(mesh)
    if "data" not in names:
        return pspec
    n = sizes["data"]
    sp = list(pspec) + [None] * (len(leaf.shape) - len(pspec))
    used = {a for s in sp if s for a in
            (s if isinstance(s, tuple) else (s,))}
    if "data" in used:   # already FSDP-sharded over data (grok experts)
        return pspec
    best = -1
    for i, (dim, s) in enumerate(zip(leaf.shape, sp)):
        if s is None and dim % n == 0 and dim >= n:
            if best < 0 or dim > leaf.shape[best]:
                best = i
    if best >= 0:
        sp[best] = "data"
    return P(*sp)


def opt_state_specs(cfg: ModelConfig, opt_shape: OptState, params_shape,
                    mesh, kind: str) -> OptState:
    """Optimizer state mirrors the parameters' specs + ZeRO-1 over "data";
    Adafactor's factored moments drop the reduced dim from the spec."""
    pspecs = param_specs(cfg, params_shape, mesh)

    if kind == "sgd":
        return OptState(P(), None, None, None)

    zspecs = tree_map(lambda s, leaf: _zero1(s, leaf, mesh), pspecs,
                      params_shape)

    if kind == "adamw":
        return OptState(step=P(), master=zspecs, m=zspecs, v=zspecs)

    # adafactor: v leaves are tuples (vr, vc) or (vfull,)
    def v_spec(pspec: Spec, vleaf):
        if len(vleaf) == 2:
            vr = P(*pspec[:-1])
            vc = P(*(pspec[:-2] + (pspec[-1],)))
            return (_zero1(vr, vleaf[0], mesh), _zero1(vc, vleaf[1], mesh))
        return (_zero1(pspec, vleaf[0], mesh),)

    v = tree_map(v_spec, pspecs, opt_shape.v)
    return OptState(step=P(), master=zspecs, m=None, v=v)


def _best_dp_subset(mesh, cfg, b: int) -> Optional[tuple]:
    """Largest prefix of the DP axes whose product divides the batch."""
    sizes = mesh_axes(mesh)[1]
    axes = list(_dp(mesh, cfg) or ())
    while axes:
        n = math.prod(sizes[a] for a in axes)
        if b % n == 0 and b >= n:
            return tuple(axes)
        axes.pop()
    return None


def batch_specs(cfg: ModelConfig, batch_shape: Dict, mesh) -> Dict:
    def one(leaf):
        if len(leaf.shape) == 0:
            return P()
        lead = _best_dp_subset(mesh, cfg, leaf.shape[0])
        return P(lead, *([None] * (len(leaf.shape) - 1)))

    return tree_map(one, batch_shape)


def cache_specs(cfg: ModelConfig, cache_shape: Dict, mesh) -> Dict:
    m = _mdl(mesh) if not cfg.pure_dp else None

    def one(path, leaf):
        name = path[-1] if path else ""
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        sp = [None] * nd
        b = leaf.shape[1] if nd > 1 else 0
        sp[1] = _best_dp_subset(mesh, cfg, b) if b else None
        if name in ("k", "v", "xk", "xv") and nd == 5:
            sp[2] = m              # (L, B, Smax, Hkv, Dh): shard sequence
        elif name == "state" and nd == 5:
            sp[2] = m              # (L, B, H, P, N): shard ssm heads
        elif name == "conv" and nd == 4:
            sp[3] = m              # (L, B, K-1, di): shard channels
        return P(*sp)

    return _with_paths(one, cache_shape)


def _place_leaf(x, sp: Spec, mesh):
    """One tensor on ``mesh`` by ``sp``: a plain tensor distributed (each
    rank holds the same value; rank 0's is sent), a DTensor redistributed;
    ``requires_grad`` kept."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    pl = placements(sp, mesh)
    if is_dtensor(x):
        return x.redistribute(mesh, pl)
    with torch.no_grad():
        out = distribute_tensor(x.detach(), mesh, pl)
    return out.requires_grad_(x.requires_grad)


def place_model(model, mesh) -> None:
    """Put ``model``'s parameters on ``mesh`` by :func:`param_specs`, in
    place: each becomes a DTensor parameter (its ``requires_grad`` kept)
    and the whole tensor it came from is dropped, so ``model.params`` is
    the placed tree and each device keeps only its shards."""
    from torch import nn

    specs = param_specs(model.cfg, model.params, mesh)

    def walk(module, sp):
        for name, p in list(module._parameters.items()):
            placed = _place_leaf(p.detach(), sp[name], mesh)
            module._parameters[name] = nn.Parameter(
                placed, requires_grad=p.requires_grad)
        for name, child in module._modules.items():
            walk(child, sp[name])

    walk(model.weights, specs)


def place(tree, specs, mesh):
    """``tree`` (a nested dict, an :class:`OptState`, an Adafactor moment
    tuple or a tensor) on ``mesh`` by the matching tree of ``specs``: the
    counterpart of ``device_put(tree, named(specs, mesh))``."""
    if tree is None:
        return None
    if isinstance(tree, OptState):
        return OptState(*(place(t, s, mesh) for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):   # an Adafactor (vr, vc) or (vfull,)
        return tuple(place(t, s, mesh) for t, s in zip(tree, specs))
    return _place_leaf(tree, specs, mesh)
