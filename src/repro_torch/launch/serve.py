"""Serving launcher: CBP-managed batched decode for any ``--arch``
(counterpart of :mod:`repro.launch.serve`).

On the card by default; ``--device cpu`` must be asked for (with the smoke
config: never build a full-size config on a CPU).  ``--full`` builds the
full config on the card, with random weights from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --requests 12 --streams 3 [--no-cbp] [--engine graph] [--device cpu]

``--engine graph`` swaps in the device engine
(:class:`~repro_torch.serving.GraphServingEngine`: one CUDA-graph replay
per reconfiguration interval on the card, eager on the CPU); ``--groups
G`` splits its streams into G independent groups, sharded over the
visible cards (``CUDA_VISIBLE_DEVICES`` chooses them), as the reference's
``--groups`` shards them over its devices; it prints the planned grid
and the device of each block.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build
from repro_torch.serving import (
    EngineConfig,
    GraphServingEngine,
    Request,
    ServingEngine,
)


def make_requests(n: int, n_streams: int, vocab: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """The reference launcher's requests: stream ``i % n_streams``;
    stream 0 a hot shared prefix (``0..7``) and 4 random tokens, the
    others 16 random tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        stream = i % n_streams
        if stream == 0:  # hot shared prefix
            prompt = np.concatenate(
                [np.arange(8), rng.integers(8, 64, 4)])
        else:
            prompt = rng.integers(0, vocab - 1, 16)
        reqs.append(Request(stream=stream, prompt=prompt.astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=configs.names())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--no-cbp", action="store_true")
    ap.add_argument("--engine", default="host", choices=("host", "graph"),
                    help="host = per-token Python loop; graph = device "
                         "programs, one CUDA-graph replay an interval")
    ap.add_argument("--groups", type=int, default=1,
                    help="stream groups for --engine graph, sharded "
                         "over the visible cards")
    ap.add_argument("--full", action="store_true",
                    help="full (non-smoke) config, on the card")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or "
                         "cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch) if args.full else configs.get_smoke(
        args.arch)
    model = build(cfg, device=args.device, seed=0)
    ecfg = EngineConfig(
        batch_slots=args.slots, max_len=96, total_pages=16 * args.streams,
        page_tokens=8,
        reconfig_every_steps=(10 ** 9 if args.no_cbp else 24))
    if args.engine == "graph":
        engine = GraphServingEngine(model, n_streams=args.streams,
                                    cfg=ecfg, n_groups=args.groups,
                                    device=args.device)
    else:
        engine = ServingEngine(model, n_streams=args.streams, cfg=ecfg,
                               device=args.device)

    reqs = make_requests(args.requests, args.streams, cfg.vocab_size,
                         args.max_new)
    t0 = time.perf_counter()
    engine.run(reqs, max_steps=5000)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"arch={args.arch} engine={args.engine} "
          f"cbp={'off' if args.no_cbp else 'on'} device={model.device} "
          f"steps={engine.steps} reconfigs={engine.reconfigs} "
          f"wall={wall:.3f}s")
    if args.engine == "graph":
        partition, hit_rate = engine.partition, engine.demand_hit_rate
    else:
        partition = engine.pool.partition
        hit_rate = [engine.pool.stats[s].hit_rate
                    for s in range(args.streams)]
    if args.engine == "graph":
        K, M, a, b = engine.grid
        print(f"  grid K={K} M={M} a={a} b={b}: groups "
              f"{engine.block_groups} on "
              f"{', '.join(str(d) for d in engine.devices)}")
    for s in range(args.streams):
        print(f"  stream {s}: pages={int(partition[s]):3d} "
              f"hit-rate={hit_rate[s]:5.1%} "
              f"slots={engine.slot_share[s]:.2f}")
    done = sum(1 for r in reqs if r.generated)
    print(f"  completed {done}/{len(reqs)}")


if __name__ == "__main__":
    main()
