"""Runs of the port on a mesh of gloo processes for the mesh tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_mesh_slow.py``).  It
imports the port only.

Run as a script, ``python tests/_torch_mesh_run.py SPEC OUT`` (SPEC a
JSON object): it spawns ``prod(mesh)`` processes
(:func:`repro_torch.launch.mesh_train.spawn`; gloo, or NCCL with
``"device": "cuda"``, one card a rank) on a ("data", "model") mesh of
shape ``mesh``, and rank 0 writes ``{case: result}`` to OUT
(``torch.save``).  Each case of ``train`` trains a smoke config changed
as the reference's gate changes it (``mesh_train.gate_config``) on
:func:`batches` with its ``optimizer`` (default AdamW), its ``weights`` (an ``.npz``-style pickle of a JAX
parameter pytree, optional) carried over with ``params_from_jax``; each
case of ``decode`` prefills nothing and runs :data:`DECODE_STEPS` decode
steps of a smoke model on a cache placed by ``cache_specs``.
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


def decode_run(cfg, mesh, device) -> dict:
    """Logits of DECODE_STEPS greedy decode steps (every rank the same
    tokens), with the model and cache on ``mesh`` (or one device)."""
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
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (DECODE_ROWS, 1), dtype=np.int64)
    out = []
    try:
        with ctx, D.mesh_context(), torch.no_grad():
            cache = model.init_cache(DECODE_ROWS, DECODE_LEN,
                                     dtype=torch.float32)
            if mesh is not None:
                cache = sh.place(cache, sh.cache_specs(cfg, cache, mesh),
                                 mesh)
            for i in range(DECODE_STEPS):
                logits, cache = model.decode_step(cache, toks, i)
                if D.is_dtensor(logits):
                    logits = logits.full_tensor()
                out.append(logits.float().numpy().copy())
                toks = logits.argmax(-1).numpy()
    finally:
        D.set_dp_axes(D.DP_AXES)
    return {"logits": out}


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
        results[case["name"]] = decode_run(cfg, mesh, device)
    if rank == 0:
        import torch
        torch.save(results, out_path)


def main() -> None:
    import math

    from repro_torch.launch.mesh_train import spawn

    spec, out_path = json.loads(sys.argv[1]), sys.argv[2]
    spawn(rank_main, math.prod(spec["mesh"]), spec, out_path,
          device=spec.get("device", "cpu"))


if __name__ == "__main__":
    main()
