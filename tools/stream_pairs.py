#!/usr/bin/env python3
"""Time the streaming sweep overlapped against serial, in alternating
pairs on one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/stream_pairs.py [--pairs 10] [--chunks 24]

The stream is the first ``--chunks`` chunks of
``benchmarks/stream_bench.py::full``'s (chunks of 512 mixes of 16 apps,
``baseline`` and ``CBP``, 50 ms, seed 11, zipf, a diurnal period of 24
chunks, a phase-app fraction of 0.25).  It runs a 2-chunk stream each way
to warm up, then ``--pairs`` pairs of warm walls, alternating which of
the two runs first (overlapped, serial; serial, overlapped; ...).  Each
pair's aggregates must be bit-identical and both runs healthy (coverage
1.0, no retry).  It prints one JSON line with every wall, the medians,
the spread (min, max) and the median of the per-pair ratios (overlapped
over serial), with the card's name and power limit, and writes it to
``chiprun_out/stream_pairs.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 512


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def config(chunks: int):
    from repro_torch.sim.stream_sweep import StreamConfig
    from repro_torch.sim.workloads import StreamScenario

    return StreamConfig(
        n_mixes=chunks * CHUNK, chunk_size=CHUNK,
        managers=("baseline", "CBP"), total_ms=50.0, seed=11,
        scenario=StreamScenario(popularity="zipf", diurnal_period_chunks=24,
                                phase_app_fraction=0.25))


def timed(cfg, overlap: bool):
    import torch
    from repro_torch.sim.stream_sweep import run_stream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = run_stream(cfg, overlap=overlap, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if report.coverage != 1.0 or report.retries:
        raise RuntimeError(f"unhealthy stream: coverage {report.coverage}, "
                           f"{report.retries} retries")
    return report, wall


def same(a, b) -> bool:
    import numpy as np

    ta, tb = a.aggregates.to_tree(), b.aggregates.to_tree()
    return all(np.array_equal(ta[k], tb[k]) for k in ta)


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--chunks", type=int, default=24)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("stream_pairs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    build.build_all()
    for overlap in (True, False):
        timed(config(2), overlap)
    cfg = config(args.chunks)
    walls = {"overlap": [], "serial": []}
    ratios = []
    for i in range(args.pairs):
        order = (True, False) if i % 2 == 0 else (False, True)
        got = {}
        for overlap in order:
            key = "overlap" if overlap else "serial"
            got[key], wall = timed(cfg, overlap)
            walls[key].append(wall)
        if not same(got["overlap"], got["serial"]):
            print(f"stream_pairs: pair {i} differs", file=sys.stderr)
            return 1
        ratios.append(walls["overlap"][-1] / walls["serial"][-1])
    line = {"chunks": args.chunks, "chunk_size": CHUNK,
            "mixes": cfg.n_mixes, "pairs": args.pairs, "walls_s": walls,
            "overlap_s": spread(walls["overlap"]),
            "serial_s": spread(walls["serial"]),
            "ratio_overlap_over_serial": spread(ratios),
            "overlap_faster_in": sum(r < 1.0 for r in ratios),
            "bit_identical": True, "card": card}
    print(json.dumps(line), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "stream_pairs.json").write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
