"""Runs of the port's pipeline on gloo processes for the pipeline tests
(``tests/test_torch_pipeline.py``).  It imports the port only (the cases'
inputs come from ``_torch_pipeline_ref``, whose import runs no JAX), so
it runs on a machine without JAX too.

Run as a script, ``python tests/_torch_pipeline_run.py WORLD OUT
[DEVICE]``: it spawns ``WORLD`` ranks
(:func:`repro_torch.launch.mesh_train.spawn`: gloo, or NCCL on a card a
rank with DEVICE ``cuda``; each wait of the group bounded by
:data:`GROUP_TIMEOUT` seconds), and each
rank runs every case of ``_torch_pipeline_ref.CASES`` whose mesh has
``WORLD`` devices, then, with two ranks, :func:`model_case` on a (2, 1)
mesh; rank ``r`` writes its results to ``OUT/rank{r}.pt``.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_pipeline_ref as ref  # noqa: E402

#: Seconds a rank waits for its partner before its group raises.
GROUP_TIMEOUT = 60.0
#: qwen3-8b's smoke config as stages: microbatches x rows x tokens.
MODEL_MICRO, MODEL_ROWS, MODEL_SEQ = 4, 2, 16


def gate_stage(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference gate's stage: ``x -> tanh(x @ w)`` for each layer."""
    for wi in w:
        x = torch.tanh(x @ wi)
    return x


def numpy_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def gate_case(name: str, device, mesh=None) -> dict:
    """One case on its mesh (or on ``mesh``): the pipeline's outputs,
    gradients of ``sum(out ** 2)`` (weights as ``(L, D, D)``, the gathered
    DTensor gradient) and the gradient's placements; and, as ``"seq"``,
    :func:`stack_case` on the same device."""
    from repro_torch import distributed as D
    from repro_torch.train.pipeline import pipeline_apply, place_stages

    if mesh is None:
        mesh = D.make_mesh(ref.CASES[name]["mesh"], ref.AXES, device)
    ws_np, x_np = ref.inputs(name)
    ws = torch.from_numpy(ws_np).to(device).requires_grad_()
    x = torch.from_numpy(x_np).to(device).requires_grad_()
    stages = place_stages(ws, mesh)
    out = pipeline_apply(gate_stage, stages, x, mesh)
    (out ** 2).sum().backward()
    res = {"out": numpy_of(out), "dx": numpy_of(x.grad),
           "dw": numpy_of(stages.grad.full_tensor().reshape(ws.shape)),
           "placements": [str(p) for p in stages.placements],
           "grad_placements": [str(p) for p in stages.grad.placements],
           "seq": stack_case(name, device)}
    return res


def stack_case(name: str, device) -> dict:
    """The case's stack run sequentially by the port, a microbatch at a
    time: outputs and gradients of ``sum(out ** 2)``."""
    ws_np, x_np = ref.inputs(name)
    ws = torch.from_numpy(ws_np).to(device).requires_grad_()
    x = torch.from_numpy(x_np).to(device).requires_grad_()
    seq = torch.stack([gate_stage(ws, x[m]) for m in range(len(x))])
    (seq ** 2).sum().backward()
    return {"out": numpy_of(seq), "dx": numpy_of(x.grad),
            "dw": numpy_of(ws.grad)}


def model_config():
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke("qwen3-8b"),
                               param_dtype="float32", remat="full")


def model_batch(cfg) -> dict:
    rng = np.random.default_rng(11)
    rows = MODEL_MICRO * MODEL_ROWS
    toks = rng.integers(0, cfg.vocab_size, (rows, MODEL_SEQ), dtype=np.int64)
    labels = rng.integers(0, cfg.vocab_size, (rows, MODEL_SEQ),
                          dtype=np.int64)
    return {"tokens": toks, "labels": labels}


def model_case(shape, device) -> dict:
    """qwen3-8b's smoke config (f32, full remat) with its layer stack
    pipelined over "pod" of a ``shape`` mesh, and the same microbatches
    through ``transformer.forward``: losses and every parameter's
    gradient (layers gathered to ``(L, ...)``), in ``tree_leaves`` order."""
    from repro_torch import distributed as D
    from repro_torch.models import build
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.pipeline import microbatch_loss, place_stages

    cfg = model_config()
    mesh = D.make_mesh(shape, ref.AXES, device)
    model = build(cfg, device, seed=0).requires_grad_(True)
    batch = model_batch(cfg)
    params = model.params
    rest = {k: v for k, v in params.items() if k != "layers"}
    plain = microbatch_loss(model, batch, MODEL_MICRO)
    g_plain = torch.autograd.grad(plain, tree_leaves(params["layers"])
                                  + tree_leaves(rest))
    stages = place_stages(params["layers"], mesh)
    piped = microbatch_loss(model, batch, MODEL_MICRO, mesh, stages)
    g_pipe = torch.autograd.grad(piped, tree_leaves(stages)
                                 + tree_leaves(rest))
    n_layer = len(tree_leaves(stages))
    g_pipe = [g.full_tensor().reshape(p.shape) if i < n_layer else g
              for i, (g, p) in enumerate(
                  zip(g_pipe, tree_leaves(params["layers"])
                      + tree_leaves(rest)))]
    return {"loss": float(piped.detach()),
            "loss_plain": float(plain.detach()),
            "grads": [numpy_of(g) for g in g_pipe],
            "grads_plain": [numpy_of(g) for g in g_plain]}


def rank_main(rank: int, device, world: int, out: str) -> None:
    results = {}
    for name, case in ref.CASES.items():
        if math.prod(case["mesh"]) == world:
            results[name] = gate_case(name, device)
    if world == 2:
        results["model"] = model_case((2, 1), device)
    torch.save(results, Path(out) / f"rank{rank}.pt")


def main(world: int, out: str, device: str = "cpu") -> None:
    from repro_torch.launch import mesh_train as mt

    torch.set_num_threads(1)
    Path(out).mkdir(parents=True, exist_ok=True)
    mt.spawn(rank_main, world, world, out, device=device,
             timeout=GROUP_TIMEOUT)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], *sys.argv[3:])
