#!/usr/bin/env python3
"""Train qwen3-8b at full width on a (2, 2) ("data", "model") mesh of
four cards, one process a card, started by ``torchrun``:

    torchrun --standalone --nproc-per-node 4 tools/mesh_train_cards.py \\
        [--steps 3] [--layers 36]

Run from the root of a checkout on a machine with 4 NVIDIA cards.  Each
rank joins an NCCL group at ``torchrun``'s rendezvous
(``repro_torch.distributed.start_ranks``), and
``repro_torch.launch.mesh_train.train_on_mesh`` builds qwen3-8b (bf16,
full remat, random weights from seed 0) on its card, places the
parameters by ``param_specs`` (tensor-parallel over "model") and the
AdamW state by ``opt_state_specs`` (ZeRO-1 over "data"), and runs AdamW
steps at lr 3e-4 on ``SyntheticTokens`` batches of 4 x 1,024 tokens
(seed 1), as ``chip_smoke.py`` phase 16(c) and 18(b) run it on one card.

Three runs, one after the other: the 8-layer cut of phase 18(b) without
a mesh on each card (the one-card run), the same on the mesh, its losses
within one bf16 rounding (rtol 2^-8) of the one-card run's, and the full
``--layers`` config on the mesh, which does not fit one card with its
AdamW state.  Rank 0 prints
one JSON line a run (the card's name and power limit, losses, step
times, warm step time, tokens/s, the largest peak memory of the four
cards and ``analytic_memory``'s per-card prediction for the mesh) and
writes them to ``chiprun_out/mesh_train_cards.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2, 2)
CUT_LAYERS, ROWS, SEQ, LR = 8, 4, 1024, 3e-4
#: The mesh's 8-layer losses against the one-card run's: bf16 products
#: summed in another order (the row-parallel products' partial sums are
#: added across "model"), so within one bf16 rounding.
LOSS_RTOL = 2.0 ** -8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=36)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if "RANK" not in os.environ:
        print("mesh_train_cards: start with torchrun --nproc-per-node 4",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import mesh_train as mt
    from repro_torch.launch.analytic import analytic_memory
    from repro_torch.models.model import ShapeSpec

    rank = int(os.environ["RANK"])
    dev = D.start_ranks(None, rank, int(os.environ["WORLD_SIZE"]))
    card = cs.card_line() if rank == 0 else ""
    rows, failed = [], []
    try:
        mesh = D.make_mesh(SHAPE, mt.AXES)

        def run(layers: int, on_mesh: bool) -> dict:
            cfg = dataclasses.replace(
                configs.get("qwen3-8b"), n_layers=layers,
                mesh_model=SHAPE[1] if on_mesh else 1)
            src = SyntheticTokens(ROWS, SEQ, cfg.vocab_size, seed=1)
            res = mt.train_on_mesh(
                cfg, mesh if on_mesh else None,
                [next(src) for _ in range(args.steps)], device=dev, lr=LR,
                microbatches=1, params_out=False)
            gc.collect()
            torch.cuda.empty_cache()
            peak = torch.tensor([float(res["peak_bytes"])], device=dev)
            torch.distributed.all_reduce(
                peak, op=torch.distributed.ReduceOp.MAX)
            chips = 4 if on_mesh else 1
            warm = statistics.median(res["step_s"][1:])
            rec = {"layers": layers, "mesh": list(SHAPE) if on_mesh
                   else None, "losses": res["losses"],
                   "step_s": res["step_s"], "warm_step_s": warm,
                   "tokens_per_s": ROWS * SEQ / warm,
                   "peak_bytes_max_card": float(peak.item()),
                   "analytic_bytes_per_card": analytic_memory(
                       cfg, ShapeSpec("train", SEQ, ROWS, "train"), chips,
                       "adamw")}
            if rank == 0:
                cs.emit(card, tool="mesh_train_cards", **rec)
            rows.append(rec)
            return rec

        cut = run(CUT_LAYERS, False)
        cut_mesh = run(CUT_LAYERS, True)
        for got, want in zip(cut_mesh["losses"], cut["losses"]):
            if abs(got - want) > LOSS_RTOL * abs(want):
                failed.append(f"{CUT_LAYERS} layers: mesh losses "
                              f"{cut_mesh['losses']} vs one card "
                              f"{cut['losses']}")
                break
        run(args.layers, True)
    finally:
        D.end_ranks()
    if rank == 0:
        out = ROOT / "chiprun_out" / "mesh_train_cards.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": rows,
                                   "failed": failed}, indent=1))
        for f in failed:
            print(f"mesh_train_cards: FAILED: {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
