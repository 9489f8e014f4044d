"""Training on a mesh of processes, one a device: the reference's
sharded-training gate (``tests/test_distributed.py``) and its launcher.

JAX trains under a GSPMD mesh in one process; ``torch.distributed`` wants
a process a device.  :func:`spawn` starts ``world_size`` processes on
this host, joins them at a ``file://`` store in a temporary directory
(:func:`repro_torch.distributed.start_ranks`: gloo on the CPU, NCCL on
cards, no network) and runs a function in each; ``torchrun`` can start
the same ranks instead (:func:`main` reads ``RANK`` and ``WORLD_SIZE``).
In each rank :func:`train_on_mesh` builds the model through the normal
entry points (``models.build``, ``train.build_train_step``), puts its
parameters on the mesh by ``param_specs`` (:func:`repro_torch.launch.
shardings.place_model`), and trains under ``use_mesh`` with the DP axes
the config asks for; every rank passes the same batch.

  PYTHONPATH=src python -m repro_torch.launch.mesh_train --device cpu \\
      --mesh 2x2 --arch qwen3-8b          # 4 gloo processes
  torchrun --nproc-per-node 4 -m repro_torch.launch.mesh_train \\
      --mesh 2x2 --arch qwen3-8b          # 4 cards

``tools/mesh_train_cards.py`` trains full configs on four cards.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch import distributed as D
from repro_torch.data import SyntheticTokens
from repro_torch.device import DeviceLike
from repro_torch.launch import shardings as sh
from repro_torch.models import build, params_from_jax
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.train import TrainStepConfig, build_train_step

#: The reference gate's configs and step (``tests/test_distributed.py``).
GATE_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-1.3b")
GATE_STEPS, GATE_LR, GATE_MICROBATCHES = 3, 1e-3, 2
GATE_BATCH, GATE_SEQ = 8, 32
AXES = ("data", "model")


def gate_config(cfg: ModelConfig, shape: Sequence[int]) -> ModelConfig:
    """``cfg`` changed as the reference's gate changes it for a
    (data, model) mesh of ``shape``: f32 parameters, the model axis's
    size, one MoE group a data shard, sequence-sharded activations and
    full remat."""
    dp, mdl = shape
    return dataclasses.replace(
        cfg, param_dtype="float32", mesh_model=mdl,
        moe_groups=dp if cfg.n_experts else 1,
        seq_shard_activations=True, remat="full")


def gate_batches(cfg: ModelConfig, steps: int, kind: str = "tokens",
                 rows: int = GATE_BATCH, seq: int = GATE_SEQ
                 ) -> List[Dict[str, np.ndarray]]:
    """The gate's batches: ``"zeros"`` is the reference's one batch of
    zeros for every step; ``"tokens"`` one seeded ``SyntheticTokens``
    batch (seed 1), the same at every step."""
    if kind == "zeros":
        toks = np.zeros((rows, seq), np.int32)
        batch = {"tokens": toks, "labels": toks}
    else:
        batch = next(SyntheticTokens(rows, seq, cfg.vocab_size, seed=1))
    return [batch] * steps


def train_on_mesh(cfg: ModelConfig, mesh, batches: Sequence[Dict],
                  *, device: DeviceLike, optimizer: str = "adamw",
                  lr: float = GATE_LR,
                  microbatches: int = GATE_MICROBATCHES, seed: int = 0,
                  weights: Optional[Dict] = None,
                  params_out: bool = True) -> Dict:
    """One training run: the model built from ``seed`` on ``device`` (or
    holding ``weights``, a JAX parameter pytree of numpy arrays, through
    ``params_from_jax``), a step for each batch.  With ``mesh`` (a
    :class:`DeviceMesh`; None trains on one device as ever) the
    parameters are placed by ``param_specs`` and every step runs under
    the mesh.  Returns the losses, each step's wall time, the peak device
    memory (the card's; 0 on the CPU) and, with ``params_out``, every
    parameter whole as f32 numpy in ``tree_leaves`` order (a collective
    under a mesh)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    model = (build(cfg, dev, seed=seed) if weights is None
             else params_from_jax(cfg, weights, dev))
    init_opt, step = build_train_step(model, TrainStepConfig(
        optimizer=optimizer, lr=lr, microbatches=microbatches))
    ctx = contextlib.nullcontext()
    if mesh is not None:
        D.set_dp_axes(sh.dp_axes_for(cfg))
        ctx = D.use_mesh(mesh)
        sh.place_model(model, mesh)
    losses, walls = [], []
    try:
        with ctx:
            params = model.params
            opt = init_opt(params)
            for batch in batches:
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["loss"]))   # waits for it
                walls.append(time.perf_counter() - t0)
            out = {"losses": losses, "step_s": walls,
                   "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if cuda else 0)}
            if params_out:
                out["params"] = [
                    (p.full_tensor() if D.is_dtensor(p) else p)
                    .detach().float().cpu().numpy().copy()
                    for p in tree_leaves(params)]
    finally:
        D.set_dp_axes(D.DP_AXES)
    return out


def _rank_main(rank: int, world: int, store: Optional[str], device: str,
               fn: Callable, args: tuple) -> None:
    dev = D.start_ranks(store, rank, world, device)
    if dev.type == "cpu":   # the host's cores shared among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        fn(rank, dev, *args)
    finally:
        D.end_ranks()


def spawn(fn: Callable, world_size: int, *args,
          device: DeviceLike = None) -> None:
    """``fn(rank, device, *args)`` in ``world_size`` new processes of this
    host, joined in one group (gloo for ``device="cpu"``, else NCCL on
    card ``rank``); returns when all have ended and raises if one failed.
    ``fn`` and ``args`` must pickle (a module-level function)."""
    import torch.multiprocessing as mp

    dev = str(device) if device is not None else "cuda"
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        mp.spawn(_rank_main, args=(world_size, os.path.join(tmp, "store"),
                                   dev, fn, args),
                 nprocs=world_size, join=True)


def gate_rank(rank: int, device: torch.device, shape: Sequence[int],
              archs: Sequence[str]) -> Dict:
    """The gate in one rank: each of ``archs`` (smoke configs changed by
    :func:`gate_config`) trained on a ``shape`` (data, model) mesh; rank 0
    prints each one's losses and step times."""
    mesh = D.make_mesh(shape, AXES, device)
    results = {}
    for arch in archs:
        cfg = gate_config(configs.get_smoke(arch), shape)
        results[arch] = train_on_mesh(
            cfg, mesh, gate_batches(cfg, GATE_STEPS), device=device,
            params_out=False)
    if rank == 0:
        print("MESH_GATE " + json.dumps({
            a: {"losses": r["losses"], "step_s": r["step_s"]}
            for a, r in results.items()}), flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2", help="(data)x(model), e.g. 2x2")
    ap.add_argument("--arch", default="qwen3-8b", choices=configs.names())
    ap.add_argument("--device", default=None,
                    help="cpu (gloo) or cuda (default: NCCL on the cards; "
                         "raises without one)")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.lower().split("x"))
    world = math.prod(shape)
    fargs = (shape, (args.arch,))
    if "RANK" in os.environ:        # started by torchrun: one rank here
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"a {args.mesh} mesh needs {world} ranks")
        _rank_main(int(os.environ["RANK"]), world, None,
                   args.device or "cuda", gate_rank, fargs)
    else:
        spawn(gate_rank, world, *fargs, device=args.device)


if __name__ == "__main__":
    main()
