#!/usr/bin/env python3
"""qwen3-8b's layer stack on the GPipe pipeline over cards, one process a
card, started by ``torchrun``:

    torchrun --standalone --nproc-per-node 2 tools/pipeline_cards.py
    torchrun --standalone --nproc-per-node 4 tools/pipeline_cards.py

Run from the root of a checkout on a machine with that many NVIDIA
cards.  Each rank joins an NCCL group at ``torchrun``'s rendezvous
(``repro_torch.distributed.start_ranks``), builds qwen3-8b at full width
(bf16, full remat, random weights from seed 0) on its card, and takes the
forward and backward pass, without an optimizer, of
``repro_torch.train.pipeline.microbatch_loss`` on ``SyntheticTokens``
microbatches of 1 x 1,024 tokens (seed 1): first without a mesh (the
one-card run, every rank the same), then with the layer stack cut into
stages over the "pod" axis of each ("pod", "data") mesh the world holds:
(2, 1) on two cards, (4, 1) and (2, 2) on four (one card: (1, 1)).

Runs: the 8-layer cut of ``chip_smoke.py`` phase 19(b) in 4 microbatches
on every mesh; with four cards (or ``--full``) also the full 36 layers in
8 microbatches on one card and at S = 4 on (4, 1).  Gates: each mesh's
loss, and the norm of each parameter's gradient (every layer of a leaf
together), within one bf16 rounding (rtol 2^-8) of the one-card run's.
Rank 0 prints one JSON line a run (the card's name and power limit, the
first step time and the warm one, the median of the :data:`WARM` after
it and the largest of the cards', tokens/s, the bubble share ``(S - 1) /
(n_micro + S - 1)`` beside the measured idle share of each card, and the
largest peak memory of the cards) and writes them to
``chiprun_out/pipeline_cards.json``.

The measured idle share of a card is one less its stage's busy time
(CUDA events around each tick's forward, and from the first to the last
node of each tick's backward) over the pipeline's own time (from the
stream entering it to the outputs leaving it, and from their cotangent
arriving to the stream's gradient leaving it), in the last run; hops and
broadcasts count as idle.  The runs are timed with the events in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUT_LAYERS, CUT_MICRO = 8, 4
FULL_LAYERS, FULL_MICRO = 36, 8
ROWS, SEQ, WARM = 1, 1024, 4
#: Each mesh's loss and gradient norms against the one-card run's: one
#: bf16 rounding (the stages run the same products; a card's own order
#: of work could still differ).
RTOL = 2.0 ** -8
MESHES = {1: [(1, 1)], 2: [(2, 1)], 4: [(4, 1), (2, 2)]}
AXES = ("pod", "data")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also the 36 layers (the default on four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # the one-card run of the 36 layers peaks near 71 GB of the 80
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if "RANK" not in os.environ:
        print("pipeline_cards: start with torchrun --nproc-per-node N",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import pipeline as P

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world not in MESHES:
        print(f"pipeline_cards: {world} ranks; want 1, 2 or 4",
              file=sys.stderr)
        return 2
    dev = D.start_ranks(None, rank, world)
    card = cs.card_line() if rank == 0 else ""
    rows, failed = [], []

    class Mark(torch.autograd.Function):
        """The identity; its backward records ``event``."""

        @staticmethod
        def forward(ctx, x, event):
            ctx.event = event
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.event.record()
            return g, None

    def event():
        return torch.cuda.Event(enable_timing=True)

    def traced(spans: dict):
        """``pipeline_apply`` with its window and each tick's work timed
        by CUDA events into ``spans``."""
        apply = P.pipeline_apply

        def stage(fn):
            def timed(params, x):
                f0, f1, b0, b1 = event(), event(), event(), event()
                x = Mark.apply(x, b1)       # its backward ends the tick's
                f0.record()
                y = fn(params, x)
                f1.record()
                spans["ticks"] += [(f0, f1), (b0, b1)]
                return Mark.apply(y, b0)    # its backward starts it
            return timed

        def run(stage_fn, stages, x, mesh, axis="pod"):
            f0, f1, b0, b1 = event(), event(), event(), event()
            x = Mark.apply(x, b1)
            f0.record()
            h = apply(stage(stage_fn), stages, x, mesh, axis)
            f1.record()
            spans["window"] += [(f0, f1), (b0, b1)]
            return Mark.apply(h, b0)

        return run

    def max_over_cards(value: float) -> float:
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return float(t.item())

    def each_card(value: float) -> list:
        t = torch.zeros(world, dtype=torch.float64, device=dev)
        t[rank] = value
        torch.distributed.all_reduce(t)
        return t.tolist()

    def one(layers: int, n_micro: int, shape) -> dict:
        """The run without a mesh (``shape`` None) or on a ``shape``
        mesh: losses, gradient norms by leaf, step times, peak memory."""
        cfg = dataclasses.replace(configs.get("qwen3-8b"), n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = build(cfg, dev, seed=0).requires_grad_(True)
        batch = next(SyntheticTokens(n_micro * ROWS, SEQ, cfg.vocab_size,
                                     seed=1))
        params = model.params
        names = [n for n, _ in _named(params["layers"])]
        rest = {k: v for k, v in params.items() if k != "layers"}
        mesh = stages = None
        if shape is not None:
            mesh = D.make_mesh(shape, AXES, dev)
            stages = P.place_stages(params["layers"], mesh)
        spans = {"ticks": [], "window": []}
        walls, losses = [], []
        saved = P.pipeline_apply
        if shape is not None:
            P.pipeline_apply = traced(spans)
        try:
            for _ in range(1 + WARM):
                spans["ticks"].clear()
                spans["window"].clear()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                loss = P.microbatch_loss(model, batch, n_micro, mesh, stages)
                stack = params["layers"] if mesh is None else stages
                grads = torch.autograd.grad(
                    loss, tree_leaves(stack) + tree_leaves(rest))
                torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                losses.append(float(loss.detach()))
        finally:
            P.pipeline_apply = saved
        norms = _norms(grads, names, [n for n, _ in _named(rest)], mesh,
                       torch)
        warm = statistics.median(walls[1:])
        tokens = n_micro * ROWS * SEQ
        rec = {"layers": layers, "microbatches": [n_micro, ROWS, SEQ],
               "mesh": list(shape) if shape else None,
               "stages": shape[0] if shape else 1,
               "losses": losses, "step_s": walls, "first_s": walls[0],
               "warm_step_s": max_over_cards(warm),
               "tokens_per_s": tokens / max_over_cards(warm),
               "peak_bytes_max_card": max_over_cards(
                   torch.cuda.max_memory_allocated(dev)),
               "grad_norms": norms}
        if shape is not None:
            s = shape[0]
            busy = sum(a.elapsed_time(b) for a, b in spans["ticks"])
            window = sum(a.elapsed_time(b) for a, b in spans["window"])
            idle = 1.0 - busy / window
            rec.update(bubble_share=(s - 1) / (n_micro + s - 1),
                       idle_share_measured=idle,
                       idle_share_by_card=each_card(idle),
                       pipeline_ms_by_card=each_card(window),
                       stage_busy_ms_by_card=each_card(busy))
        del model, params, rest, stages, grads, loss
        if rank == 0:
            cs.emit(card, tool="pipeline_cards", **rec)
        rows.append(rec)
        return rec

    def gate(got: dict, want: dict) -> None:
        what = f"{got['layers']} layers on {got['mesh']}"
        for a, b in zip(got["losses"], want["losses"]):
            if abs(a - b) > RTOL * abs(b):
                failed.append(f"{what}: losses {got['losses']} vs one card "
                              f"{want['losses']}")
                break
        for name, b in want["grad_norms"].items():
            a = got["grad_norms"][name]
            if abs(a - b) > RTOL * abs(b):
                failed.append(f"{what}: gradient norm of {name} {a} vs one "
                              f"card {b}")

    try:
        base = one(CUT_LAYERS, CUT_MICRO, None)
        for shape in MESHES[world]:
            gate(one(CUT_LAYERS, CUT_MICRO, shape), base)
        if world == 4 or args.full:
            full = one(FULL_LAYERS, FULL_MICRO, None)
            gate(one(FULL_LAYERS, FULL_MICRO, (world, 1)), full)
    finally:
        D.end_ranks()
    if rank == 0:
        out = ROOT / "chiprun_out" / "pipeline_cards.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps({"card": card, "world": world,
                                   "runs": rows, "failed": failed},
                                  indent=1))
        for f in failed:
            print(f"pipeline_cards: FAILED: {f}", file=sys.stderr)
    return 1 if failed else 0


def _named(tree, path=()):
    """``(path, leaf)`` of a nested dict in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _norms(grads, layer_names, rest_names, mesh, torch) -> dict:
    """The 2-norm of each gradient, by name: the layer leaves summed over
    the stages ("pod") of ``mesh``, the rest as they are (the same on
    every rank)."""
    from repro_torch import distributed as D

    sq = []
    for g in grads[:len(layer_names)]:
        local = g.to_local() if D.is_dtensor(g) else g
        sq.append(local.float().pow(2).sum())
    sq = torch.stack(sq)
    if mesh is not None and mesh.size(0) > 1:
        torch.distributed.all_reduce(sq, group=mesh.get_group("pod"))
    out = {f"layers/{n}": math.sqrt(float(v))
           for n, v in zip(layer_names, sq)}
    for n, g in zip(rest_names, grads[len(layer_names):]):
        out[n] = float(g.float().norm())
    return out


if __name__ == "__main__":
    sys.exit(main())
