#!/usr/bin/env python3
"""Time the Table-3 sweep in length buckets against one stacked table, in
alternating pairs on one card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/bucket_pairs.py [--pairs 10] [--mixes 32 4096]

For each mix count it builds ``random_mixes(M, 16, seed=1)``, runs all 14
managers over 100 ms once each way to warm up, then ``--pairs`` pairs of
warm walls, alternating which of the two runs first (buckets, one table;
one table, buckets; ...).  One table is the same sweep with the bucket
rule (``repro_torch.sim.timeline._length_buckets``) made to return one
group.  Each pair's results must be bit-identical.  It prints one JSON
line per mix count with every wall, the medians, the spread (min, max)
and the median of the per-pair ratios (buckets over one table), each with
the card's name and power limit, and writes the same lines to
``chiprun_out/bucket_pairs.json``.
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
TOTAL_MS, N_APPS, SEED = 100.0, 16, 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def one_table_rule(lens):
    return [list(range(len(lens)))]


def timed(mixes, flat: bool):
    import torch
    from repro_torch.core.dispatch import launch_counts, reset_launch_counts
    from repro_torch.sim import run_sweep, timeline

    real = timeline._length_buckets
    if flat:
        timeline._length_buckets = one_table_rule
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep(mixes, total_ms=TOTAL_MS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        timeline._length_buckets = real
    return res, wall, launch_counts()["lookahead_greedy"]


def same(a, b) -> bool:
    import numpy as np

    return all(
        np.array_equal(a.ipc[k], b.ipc[k])
        and all(np.array_equal(getattr(a.final_alloc[k], f),
                               getattr(b.final_alloc[k], f))
                for f in ("cache_units", "bandwidth", "prefetch_on"))
        for k in a.manager_names)


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--mixes", type=int, nargs="+", default=[32, 4096])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bucket_pairs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.sim import random_mixes

    card = card_line()
    build.build_all()
    lines = []
    for m in args.mixes:
        mixes = random_mixes(m, N_APPS, seed=SEED)
        timed(mixes, False)
        timed(mixes, True)
        walls = {"buckets": [], "one_table": []}
        launches = {}
        ratios = []
        for i in range(args.pairs):
            order = (False, True) if i % 2 == 0 else (True, False)
            got = {}
            for flat in order:
                res, wall, n = timed(mixes, flat)
                key = "one_table" if flat else "buckets"
                got[key] = res
                walls[key].append(wall)
                launches[key] = n
            if not same(got["buckets"], got["one_table"]):
                print(f"bucket_pairs: pair {i} at {m} mixes differs",
                      file=sys.stderr)
                return 1
            ratios.append(walls["buckets"][-1] / walls["one_table"][-1])
        line = {"mixes": m, "managers": 14, "total_ms": TOTAL_MS,
                "pairs": args.pairs, "walls_s": walls,
                "buckets_s": spread(walls["buckets"]),
                "one_table_s": spread(walls["one_table"]),
                "ratio_buckets_over_one_table": spread(ratios),
                "greedy_launches": launches, "bit_identical": True,
                "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bucket_pairs.json").write_text(
        "\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
