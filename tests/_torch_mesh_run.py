"""Runs of the port on a mesh of gloo processes for the mesh tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_mesh_slow.py``,
``tests/test_torch_dryrun.py``).  It imports the port only.

Run as a script, ``python tests/_torch_mesh_run.py SPEC OUT`` (SPEC a
JSON object): it spawns ``prod(mesh)`` processes
(:func:`repro_torch.launch.mesh_train.spawn`; gloo, or NCCL with
``"device": "cuda"``, one card a rank) on a ("data", "model") mesh of
shape ``mesh``, and rank 0 writes ``{case: result}`` to OUT
(``torch.save``); ``"timeout"`` (seconds) bounds each wait of the
group.  Each case of ``train`` trains a smoke config changed
as the reference's gate changes it (``mesh_train.gate_config``) on
:func:`batches` with its ``optimizer`` (default AdamW), its ``weights`` (an ``.npz``-style pickle of a JAX
parameter pytree, optional) carried over with ``params_from_jax``; each
case of ``decode`` prefills nothing and runs :data:`DECODE_STEPS` decode
steps of a smoke model on a cache placed by ``cache_specs`` (``"inplace"``
writes into the cache's own tensors, ``"both"`` decodes both ways); each
case of ``count`` counts one step of a smoke config made by the dry run
(:func:`count_run`), on every rank, as a fake group's one rank counts it
(``tests/test_torch_dryrun.py``); each case of ``grads`` takes the loss
and every gradient of one batch of ``rows`` rows (:func:`grads_run`).
"""
from __future__ import annotations

import json
import pickle
import sys

import numpy as np

#: Decode steps of a ``decode`` case, at rows x one token.
DECODE_STEPS, DECODE_ROWS, DECODE_LEN = 3, 8, 16


def batches(cfg, kind: str, steps: int, rows: int = 8, seq: int = 32):
    """``steps`` copies of one batch for ``cfg``'s family: ``"zeros"``
    (the reference gate's), else seeded tokens, and frames (whisper) or
    embeddings (the stub frontends) drawn with numpy."""
    from repro_torch.launch.mesh_train import gate_batches

    if kind == "zeros" or cfg.family not in ("encdec",) and \
            cfg.frontend not in ("audio", "patch"):
        return gate_batches(cfg, steps, kind, rows, seq)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq), dtype=np.int32)
    emb = rng.standard_normal((rows, seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch = {"tokens": toks, "labels": toks, "frames": emb}
    else:
        batch = {"embeddings": emb, "labels": toks}
    return [batch] * steps


def decode_run(cfg, mesh, device, inplace=False) -> dict:
    """Logits of DECODE_STEPS greedy decode steps (every rank the same
    tokens), with the model and cache on ``mesh`` (or one device); with
    ``inplace`` each step writes into the cache's own tensors.  Also the
    last cache whole, and for each of its tensors on a mesh whether the
    local shape agrees with its placements.  ``inplace="both"`` runs the
    steps out of place, then in place on a fresh cache, with one model:
    ``{"out": ..., "inplace": ...}``."""
    import contextlib

    import torch

    from repro_torch import distributed as D
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build

    model = build(cfg, device, seed=0)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        D.set_dp_axes(sh.dp_axes_for(cfg))
        sh.place_model(model, mesh)
        ctx = D.use_mesh(mesh)

    def steps(write_inplace: bool) -> dict:
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size, (DECODE_ROWS, 1),
                            dtype=np.int64)
        out = []
        cache = model.init_cache(DECODE_ROWS, DECODE_LEN,
                                 dtype=torch.float32)
        if mesh is not None:
            cache = sh.place(cache, sh.cache_specs(cfg, cache, mesh), mesh)
        for i in range(DECODE_STEPS):
            logits, cache = model.decode_step(cache, toks, i,
                                              inplace=write_inplace)
            if D.is_dtensor(logits):
                logits = logits.full_tensor()
            out.append(logits.float().numpy().copy())
            toks = logits.argmax(-1).numpy()
        whole, layout = {}, {}
        for k, t in cache.items():
            if D.is_dtensor(t):
                want = [n // np.prod([t.device_mesh.size(j) for j, p in
                                      enumerate(t.placements)
                                      if p.is_shard(i)], dtype=int)
                        for i, n in enumerate(t.shape)]
                layout[k] = list(t.to_local().shape) == want
                t = t.full_tensor()
            whole[k] = t.float().numpy().copy()
        return {"logits": out, "cache": whole, "layout": layout}

    try:
        with ctx, D.mesh_context(), torch.no_grad():
            if inplace == "both":
                return {"out": steps(False), "inplace": steps(True)}
            return steps(bool(inplace))
    finally:
        D.set_dp_axes(D.DP_AXES)


def grads_run(cfg, mesh, device, rows: int, seq: int = 32) -> dict:
    """The loss of one seeded batch of ``rows`` rows and its gradient
    with respect to every parameter (whole, f32 numpy, in ``tree_leaves``
    order), the step's loss function on ``mesh`` (or one device), as the
    train step takes each microbatch's."""
    import contextlib

    import torch

    from repro_torch import distributed as D
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import family_module

    model = build(cfg, device, seed=0).requires_grad_(True)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        D.set_dp_axes(sh.dp_axes_for(cfg))
        sh.place_model(model, mesh)
        ctx = D.use_mesh(mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             batches(cfg, "tokens", 1, rows=rows, seq=seq)[0].items()}
    try:
        with ctx, D.mesh_context():
            if mesh is not None:
                batch = sh.place(batch, sh.batch_specs(cfg, batch, mesh),
                                 mesh)
            params = model.params
            loss = family_module(cfg).loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, tree_leaves(params),
                                        allow_unused=True,
                                        materialize_grads=True)
            whole = lambda t: (t.full_tensor() if D.is_dtensor(t)  # noqa
                               else t).detach().float().numpy().copy()
            return {"loss": float(whole(loss)),
                    "grads": [whole(g) for g in grads]}
    finally:
        D.set_dp_axes(D.DP_AXES)


def count_config(arch: str, shape, seq_shard: bool = False):
    """``arch``'s smoke config as the dry run sets it for a (data, model)
    mesh of ``shape``; ``seq_shard`` shards the residual stream's sequence
    over "model" (the layout the reference's gate trains in)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_smoke(arch).with_mesh(shape[1], shape[0])
    return dataclasses.replace(cfg, seq_shard_activations=seq_shard)


def count_run(cfg, mesh, device, kind: str = "train", rows: int = 8,
              seq: int = 32, microbatches: int = 1, meta: bool = False
              ) -> dict:
    """One step of ``cfg`` (built from seed 0 on ``device``, or on
    ``meta``) made by the dry run's ``build_cell`` on ``mesh`` at
    ``rows`` x ``seq`` (AdamW for a train step), counted by
    ``op_costs.trace``: the cost, argument and peak bytes and FLOPs by
    op."""
    import dataclasses

    from repro_torch import distributed as D
    from repro_torch.launch import dryrun, op_costs
    from repro_torch.launch import shardings as sh
    from repro_torch.models import build
    from repro_torch.models.model import ShapeSpec

    model = dryrun.meta_model(cfg) if meta else build(cfg, device, seed=0)
    D.set_dp_axes(sh.dp_axes_for(cfg))
    try:
        with D.use_mesh(mesh):
            fn, args = dryrun.build_cell(
                model, ShapeSpec("count", seq, rows, kind), mesh, "adamw",
                microbatches)
            _, cost, counter = op_costs.trace(fn, *args)
    finally:
        D.set_dp_axes(D.DP_AXES)
    return {"cost": dataclasses.asdict(cost),
            "argument_bytes": counter.argument_bytes,
            "peak_bytes": counter.peak_bytes,
            "flops_by_op": counter.flops_by_op,
            "shapes": sorted(counter.shapes)}


def rank_main(rank, device, spec: dict, out_path: str) -> None:
    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.launch import mesh_train as mt

    shape = tuple(spec["mesh"])
    mesh = D.make_mesh(shape, mt.AXES, device)
    results = {}
    for case in spec.get("train", []):
        cfg = mt.gate_config(configs.get_smoke(case["arch"]), shape)
        weights = None
        if case.get("weights"):
            with open(case["weights"], "rb") as f:
                weights = pickle.load(f)
        results[case["name"]] = mt.train_on_mesh(
            cfg, mesh, batches(cfg, case["batch"], case["steps"]),
            device=device, weights=weights,
            optimizer=case.get("optimizer", "adamw"))
    for case in spec.get("decode", []):
        cfg = mt.gate_config(configs.get_smoke(case["arch"]), shape)
        results[case["name"]] = decode_run(cfg, mesh, device,
                                           case.get("inplace", False))
    for case in spec.get("grads", []):
        cfg = mt.gate_config(configs.get_smoke(case["arch"]), shape)
        results[case["name"]] = grads_run(cfg, mesh, device, case["rows"])
    for case in spec.get("count", []):
        cfg = count_config(case["arch"], shape, case.get("seq_shard", False))
        results[case["name"]] = count_run(
            cfg, mesh, device, case.get("kind", "train"), case["rows"],
            case["seq"], case.get("microbatches", 1))
    if rank == 0:
        import torch
        torch.save(results, out_path)


def main() -> None:
    import math

    from repro_torch.launch.mesh_train import spawn

    spec, out_path = json.loads(sys.argv[1]), sys.argv[2]
    spawn(rank_main, math.prod(spec["mesh"]), spec, out_path,
          device=spec.get("device", "cpu"), timeout=spec.get("timeout"))


if __name__ == "__main__":
    main()
