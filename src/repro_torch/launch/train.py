"""Training launcher: fault-tolerant loop with a CBP-managed input
pipeline (counterpart of :mod:`repro.launch.train`).

On the card by default; ``device="cpu"`` (``--device cpu``) must be asked
for, with a smoke config: never build a full-size config on a CPU.
``--full`` builds the full config on the card, with random weights from
seed 0, and first prints ``analytic_memory``'s figures for one card and
the optimizer (:mod:`repro_torch.launch.analytic`); a full config fits
one 80 GB card only where its parameters and optimizer state do (AdamW
keeps 16 bytes a bf16 parameter: qwen3-8b's 36 layers need 131 GB, so it
does not fit whole).  This loop runs on one device, as the reference's
does; a config that needs several cards trains on a mesh of processes,
one a card (:mod:`repro_torch.launch.mesh_train`, ``torchrun``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --steps 50 [--optimizer adafactor] [--ckpt DIR] [--device cpu]

Features, as the reference's (and tested on the port as in
``tests/test_train_loop.py``):
  * checkpoint/restart (atomic, keep-k, async) with pipeline resume,
  * straggler watchdog on step times,
  * CBP's A/B throttle of the pipeline's prefetch depth every 16 steps,
  * microbatched train step, AdamW/Adafactor/SGD.
"""
from __future__ import annotations

import argparse
import pathlib
import time
from typing import Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import PrefetchPipeline, SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.analytic import analytic_memory
from repro_torch.models import build
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import ShapeSpec
from repro_torch.runtime.fault import StragglerWatchdog
from repro_torch.train.step import TrainStepConfig, build_train_step


def train_loop(
    arch: str,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    lr: float = 1e-3,
    optimizer: str = "adamw",
    microbatches: int = 1,
    ckpt_dir: Optional[pathlib.Path] = None,
    ckpt_every: int = 20,
    smoke: bool = True,
    log_every: int = 10,
    cbp_manage: bool = True,
    device: DeviceLike = None,
) -> Dict:
    dev = resolve_device(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    model = build(cfg, dev, seed=0)
    tcfg = TrainStepConfig(optimizer=optimizer, lr=lr,
                           microbatches=microbatches)
    init_opt, train_step = build_train_step(model, tcfg)

    params = model.params
    opt_state = init_opt(params)
    source = SyntheticTokens(batch, seq, cfg.vocab_size, seed=1)
    pipe = PrefetchPipeline(source, depth=2)
    watchdog = StragglerWatchdog()
    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None

    start_step = 0
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            start_step, tree, extra = restored
            with torch.no_grad():   # into the model's own tensors
                for p, value in zip(tree_leaves(params),
                                    tree_leaves(tree["params"])):
                    p.copy_(value)
            opt_state = tree["opt"]
            if "data" in extra:
                source.restore(extra["data"])

    losses: List[float] = []
    mitigations = 0
    pf_decision_log = []
    for step in range(start_step, steps):
        batch_np = next(pipe)
        t0 = time.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch_np)
        loss = float(metrics["loss"])   # waits for the step
        dt = time.monotonic() - t0
        if watchdog.observe(step, dt):
            mitigations += 1
        losses.append(loss)

        # CBP prefetch throttle: A/B the pipeline depth on step throughput
        if cbp_manage and step > 0 and step % 16 == 0:
            tp_with = pipe.throughput()
            pipe.set_depth(0 if pipe.depth else 2)
            pf_decision_log.append((step, pipe.depth, tp_with))

        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1,
                           {"params": params, "opt": opt_state},
                           extra={"data": source.state()})
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms",
                  flush=True)
    if mgr is not None:
        mgr.wait()
    pipe.stop()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "mitigations": mitigations, "params": params}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=configs.names())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full", action="store_true",
                    help="full (non-smoke) config, on the card; it must fit "
                         "one card with its optimizer state (AdamW: 16 "
                         "bytes a bf16 parameter, so qwen3-8b's 36 layers "
                         "need 131 GB and do not fit one 80 GB card); "
                         "prints analytic_memory's figures first")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    args = ap.parse_args(argv)
    if args.full:
        spec = ShapeSpec("train", args.seq, args.batch, "train")
        mem = analytic_memory(configs.get(args.arch), spec, 1,
                              args.optimizer)
        print(f"analytic memory, one card, {args.optimizer}: "
              + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in mem.items()),
              flush=True)
    out = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, optimizer=args.optimizer,
        microbatches=args.microbatches,
        ckpt_dir=pathlib.Path(args.ckpt) if args.ckpt else None,
        smoke=not args.full, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
