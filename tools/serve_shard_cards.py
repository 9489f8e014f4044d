#!/usr/bin/env python3
"""Time the serving engine's groups sharded over real cards against the
same groups on one card.

Run from the root of a checkout on a machine with 2 or more NVIDIA cards
(4 for the 4-group case):

    python3 tools/serve_shard_cards.py [--requests 16]

qwen3-8b at its full config (bf16, random weights from seed 0) behind
``GraphServingEngine`` at ``chip_smoke.py`` phase 15(b)'s engine
configuration (4 streams, 16 slots, 512 positions, 256 pages of 16
tokens, a reconfiguration every 32 steps) on the first ``--requests`` of
its requests.  For 2 groups: the unsharded engine (one block on cuda:0),
both blocks forced onto cuda:0, and one block a card on cuda:0 and
cuda:1 (the second block on a replica of the model); for 4 groups (with
4 cards): unsharded, and one block a card.  Each engine runs cold (its
captures, and for cards past the first the replica's copy, timed apart)
and warm; every sharded run is held to its unsharded run as phase 17(f)
holds it (tokens under the token rule, discrete outputs exact, shares and
waits within 1e-6).  It prints one JSON line a case with the card's name
and power limit (warm ms a step, tokens/s, capture seconds per block,
replays and greedy launches of the warm run, peak memory per card, and
an interval of every block replayed alone and all blocks launched
together, from the one thread and from a thread a block: device ms per
block, host ms per launch call), and writes them to
``chiprun_out/serve_shard_cards.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if torch.cuda.device_count() < 2:
        print("serve_shard_cards: needs 2 or more CUDA cards",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs, distributed
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.kernels import build as kernels
    from repro_torch.models import build
    from repro_torch.serving import GraphServingEngine

    card = cs.card_line()
    kernels.build_all()
    cfg = configs.get("qwen3-8b")
    model = build(cfg, "cuda:0", seed=0)
    ecfg = cs.serve_config()
    n_cards = torch.cuda.device_count()

    def make():
        return cs.serve_requests(cfg.vocab_size)[:args.requests]

    def sync_all():
        for i in range(n_cards):
            torch.cuda.synchronize(i)

    def timed(eng):
        reqs = make()
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
        sync_all()
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.run(reqs, max_steps=cs.SERVE_MAX_STEPS)
        sync_all()
        wall = time.perf_counter() - t0
        return reqs, wall, launch_counts(), [
            torch.cuda.max_memory_allocated(i) for i in range(n_cards)]

    def overlap_probe(eng) -> dict:
        """Each block's interval program replayed alone, then all of them
        launched one after another and their flags read after, as
        ``run()`` does, then launched from one thread a block: the device
        ms of each (CUDA events on its card), the host ms each launch call
        took and the host wall of each round."""
        programs = [run.steps for run in eng._runs.values()]

        def timed_launch(program):
            with torch.cuda.device(program.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                out = program.run()
                host = time.perf_counter() - t0
                end.record()
            return start, end, out, host

        alone = []
        for program in programs:
            start, end, _, _ = timed_launch(program)
            end.synchronize()
            alone.append(start.elapsed_time(end))
        def round_(launch_all):
            sync_all()
            t0 = time.perf_counter()
            launched = launch_all()
            for _, _, out, _ in launched:
                out.tolist()
            wall = time.perf_counter() - t0
            sync_all()
            return {"device_ms": [s.elapsed_time(e)
                                  for s, e, _, _ in launched],
                    "launch_host_ms": [1e3 * h for _, _, _, h in launched],
                    "wall_ms": 1e3 * wall}

        with ThreadPoolExecutor(len(programs)) as pool:
            threaded = round_(lambda: list(pool.map(timed_launch,
                                                    programs)))
        return {"alone_ms": alone,
                "together": round_(lambda: [timed_launch(p)
                                            for p in programs]),
                "together_launched_by_threads": threaded}

    cases = [(2, "unsharded", [0]), (2, "forced_on_cuda0", [0, 0]),
             (2, "cards", [0, 1])]
    if n_cards >= 4:
        cases += [(4, "unsharded", [0]), (4, "cards", [0, 1, 2, 3])]
    rows, want = [], {}
    for groups, name, idx in cases:
        devices = [torch.device("cuda", i) for i in idx]
        sync_all()
        t0 = time.perf_counter()
        with distributed.use_devices(devices):
            eng = GraphServingEngine(model, cs.SERVE_STREAMS, ecfg,
                                     n_groups=groups, device="cuda")
        sync_all()
        setup = time.perf_counter() - t0
        _, cold, _, _ = timed(eng)
        capture = dict(eng.capture_seconds)
        reqs, wall, counts, peaks = timed(eng)
        out = cs.shard_outputs(eng, reqs)
        if name == "unsharded":
            want[groups] = out
            gate = None
        else:
            gate = cs.serve_shard_gate(
                out, want[groups],
                cs.host_margins(model, cs.SERVE_STREAMS, ecfg, make),
                f"serve_shard_cards {groups} groups {name}")
        gen = sum(len(r.generated) for r in reqs)
        row = {"groups": groups, "case": name, "grid": list(eng.grid),
               "devices": [str(d) for d in eng.devices],
               "replicas": sum(m is not model for m in eng._models),
               "setup_s": setup, "cold_wall_s": cold,
               "capture_seconds": capture, "warm_wall_s": wall,
               "steps": eng.steps,
               "warm_ms_per_step": 1e3 * wall / eng.steps,
               "generated_tokens_per_s": gen / wall,
               "block_reconfigs": eng.block_reconfigs,
               "launches": {k: v for k, v in counts.items() if v},
               "peak_bytes_per_card": peaks, "vs_unsharded": gate,
               "interval_probe": overlap_probe(eng), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_shard_cards.json").write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
