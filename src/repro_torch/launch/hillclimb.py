"""§Perf hill-climb harness (counterpart of the reference's
``tools/hillclimb.py``): build a cell variant on the production mesh and
report its three roofline terms; or refine Fig. 5's static winners.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe_train \\
      --variant v1_remat_dots
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --all --device cpu

A variant runs as the dry run runs a cell (:mod:`repro_torch.launch.
dryrun`): one process is rank 0 of a fake group of the single pod's 256
ranks, every tensor on ``meta``, the step traced once under
:class:`repro_torch.launch.op_costs.CostCounter`; so the record's
``trace_s`` stands where the reference's ``compile_s`` stands, and its
``peak_gib`` is the counter's per-device peak estimate.  Records go to
``results/perf_torch/`` (one JSON a variant and device type).

``--fig5-seed`` refines the Fig. 5 static-allocation winners on a finer
lattice, seeded from the batched search's top-k
(:func:`repro_torch.sim.static_search.search_static`), each candidate
scored by the port's interval model in float64 on ``--device``;
``--multi-objective`` seeds from the (weighted speedup, min-fairness)
Pareto front, knee point first:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --fig5-seed \\
      [--multi-objective] [--device cpu]

Without ``--device cpu`` the mesh is a card mesh and the climb runs on
the card; either raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

OUT = pathlib.Path(__file__).resolve().parents[3] / "results" / "perf_torch"

# cell -> (arch, shape, optimizer, baseline_microbatches)
CELLS = {
    "moe_train": ("qwen3-moe-30b-a3b", "train_4k", "adafactor", 2),
    "grok_train": ("grok-1-314b", "train_4k", "adafactor", 8),
    "dense_decode": ("qwen3-8b", "decode_32k", "adamw", 1),
}

# variant -> (config overrides, microbatch override, note)
VARIANTS = {
    "moe_train": {
        "baseline": ({}, None, "paper-faithful baseline (remat=full, cf=1.25, mb=2)"),
        "v1_remat_dots": ({"remat": "dots"}, None,
                          "H: full remat re-reads each layer in bwd; saving dot outputs cuts HBM term ~25% at higher peak mem"),
        "v2_cf_1.0": ({"capacity_factor": 1.0}, None,
                      "H: capacity 1.25->1.0 trims expert compute+buffer traffic ~20% (drops overflow tokens)"),
        "v3_mb_1": ({}, 1, "H: single microbatch halves per-step expert-weight re-reads"),
        "v4_chunk_2048": ({"attn_chunk": 2048, "capacity_factor": 1.0},
                          None,
                          "H: halving the q-chunk count halves per-layer K/V re-reads in the chunked attention (+ keep the confirmed cf=1.0 trim)"),
    },
    "grok_train": {
        "baseline": ({}, None, "paper-faithful baseline (mb=8, FSDP experts)"),
        "v1_mb_2": ({}, 2, "H: FSDP weight all-gathers repeat per microbatch; mb 8->2 divides the AG term ~4x"),
        "v2_mb_2_dots": ({"remat": "dots"}, 2,
                         "H: remat recompute re-gathers weights; dots policy avoids the remat re-AG"),
        "v3_mb_1": ({}, 1, "H: mb=1 halves AG again if activations fit"),
        "v4_gather_weights": ({"moe_gather_weights": True}, 2,
                              "H: the residual collectives are partial-sum ARs from the FSDP d-contraction; gathering weights first costs one 613MB AG/layer instead"),
        "v5_cf_1.0": ({"capacity_factor": 1.0}, 2,
                      "H: the 720GiB AR is the row-parallel expert DOWN output, sized e*cap = cf*topk*tokens; cf 1.25->1.0 trims it (and the dispatch buffers) 20%"),
    },
    "dense_decode": {
        "baseline": ({"decode_cache_update": "dus", "decode_gqa": "repeat"}, None, "paper-faithful baseline (DUS cache write)"),
        "v1_onehot": ({"decode_cache_update": "onehot"}, None,
                      "H: dynamic-slice write into the seq-sharded cache makes GSPMD all-gather it; one-hot masked update stays sharded -> collective term collapses"),
        "v2_onehot_chunk": ({"decode_cache_update": "onehot",
                             "attn_chunk": 2048}, None,
                            "H: after C1 the memory term (cache read) dominates and is irreducible per token; chunk size should be neutral"),
        "v3_seq_sharded_q": ({"decode_cache_update": "onehot"}, None,
                             "H: the 72 GiB of AGs are GSPMD replicating the repeat_kv broadcast (q heads-sharded vs cache seq-sharded); replicating the tiny q keeps attention seq-local -> collective term collapses"),
        "v4_grouped_gqa": ({"decode_cache_update": "onehot",
                            "decode_gqa": "grouped"}, None,
                           "H: repeat_kv materializes 4x the cache per layer; the grouped einsum reads KV once -> memory term ~-60%"),
        "v5_int8_kv": ({"decode_cache_update": "onehot",
                        "decode_gqa": "grouped",
                        "kv_cache_dtype": "int8"}, None,
                       "H: int8 KV cache halves the dominant cache-read traffic -> memory term ~-40% (accuracy traded; serving-standard)"),
    },
}

#: The single pod's ranks, as the reference's ``make_production_mesh()``.
CHIPS = 256


def _path(results_dir, name: str, device_type: str) -> pathlib.Path:
    return pathlib.Path(results_dir or OUT) / f"{name}__{device_type}.json"


def run_variant(cell: str, variant: str, force: bool = False,
                device: DeviceLike = None,
                results_dir: Optional[pathlib.Path] = None) -> Dict:
    """One variant's record, from the cache unless ``force``: the cell's
    step with the variant's overrides, traced on a fake group of the
    single pod (a mesh of ``device``'s type; None: the card's, which
    raises without one).  Errors are recorded as data."""
    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import (dp_size, make_production_mesh,
                                         model_size)
    from repro_torch.launch.op_costs import trace
    from repro_torch.models.model import SHAPES

    dev = resolve_device(device)
    path = _path(results_dir, f"{cell}__{variant}", dev.type)
    if path.exists() and not force:
        return json.loads(path.read_text())
    arch, shape, optimizer, base_mb = CELLS[cell]
    overrides, mb, note = VARIANTS[cell][variant]
    spec = SHAPES[shape]
    rec = {"cell": cell, "variant": variant, "note": note,
           "overrides": overrides, "microbatches": mb or base_mb}
    t0 = time.time()
    try:
        D.start_fake_ranks(CHIPS)
        mesh = make_production_mesh(device=dev)
        cfg = dataclasses.replace(configs.get(arch).with_mesh(
            model_size(mesh), dp_size(mesh)), **overrides)
        D.set_dp_axes(sh.dp_axes_for(cfg))
        with D.use_mesh(mesh):
            fn, args = dryrun.build_cell(dryrun.meta_model(cfg), spec,
                                         mesh, optimizer, mb or base_mb)
            _, cost, counter = trace(fn, *args)
        terms = {
            "compute_s": cost.flops / dryrun.PEAK_FLOPS,
            "memory_s": cost.hbm_bytes / dryrun.HBM_BW,
            "collective_s": cost.total_collective_bytes / dryrun.LINK_BW,
        }
        rec.update({
            "status": "ok",
            "trace_s": round(time.time() - t0, 1),
            **{k: round(v, 4) for k, v in terms.items()},
            "dominant": max(terms, key=terms.get),
            "bound_s": round(max(terms.values()), 4),
            "roofline_fraction": round(
                terms["compute_s"] / max(max(terms.values()), 1e-12), 4),
            "useful_ratio": round(
                dryrun.model_flops(cfg, spec, CHIPS) / max(cost.flops, 1.0),
                4),
            "peak_gib": round(counter.peak_bytes / 2**30, 2),
            "collective_bytes": {k: round(v / 2**30, 2)
                                 for k, v in cost.collective_bytes.items()},
        })
    except Exception as exc:  # noqa: BLE001 — record failures as data
        rec["status"] = "error"
        rec["error"] = f"{type(exc).__name__}: {exc}"[:500]
    finally:
        D.set_dp_axes(("pod", "data"))
        D.end_ranks()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=float))
    return rec


# ------------------------------------------------------------------ #
# Fig. 5: the seeded climb
# ------------------------------------------------------------------ #

FIG5_FAMILY = "cache+bw+pref"
#: A move is accepted where it raises the weighted speedup by more than
#: this (the reference's threshold).
ACCEPT = 1e-9


def _moves(n: int) -> List[tuple]:
    """The reference's moves in its order: for each app a prefetch flip,
    then transfers of 2 or 4 cache units and 0.5 or 1 GB/s from each other
    app to it."""
    moves = []
    for i in range(n):
        moves.append(("p", i, i, 0.0))
        for j in range(n):
            if i == j:
                continue
            moves.extend(("c", i, j, s) for s in (2.0, 4.0))
            moves.extend(("b", i, j, s) for s in (0.5, 1.0))
    return moves


def _apply(move, c, b, p):
    """The allocation after ``move``, or None where it leaves an app below
    4 cache units or 0.5 GB/s."""
    kind, i, j, step = move
    c2, b2, p2 = c.copy(), b.copy(), p.copy()
    if kind == "c":            # transfer units from j to i
        c2[i] += step
        c2[j] -= step
        if c2[j] < 4.0:
            return None
    elif kind == "b":          # transfer bandwidth j -> i
        b2[i] += step
        b2[j] -= step
        if b2[j] < 0.5:
            return None
    else:
        p2[i] = 1.0 - p2[i]
    return c2, b2, p2


def climb(c, b, p, score, n: int):
    """The reference's first-improvement climb from ``(c, b, p)``: passes
    over :func:`_moves` in order, each feasible move scored from the
    current allocation and taken where it gains more than
    :data:`ACCEPT`, until a pass takes none.  ``score(rows)`` scores a
    batch of allocations (three ``(M, n)`` arrays) at once; the moves
    after a taken one are scored from the new allocation, so the path is
    the sequential climb's.  Returns ``(c, b, p, ws)``."""
    moves = _moves(n)
    cur = float(score(c[None], b[None], p[None])[0])
    improved = True
    while improved:
        improved = False
        pos = 0
        while pos < len(moves):
            trials = [(k, _apply(moves[k], c, b, p))
                      for k in range(pos, len(moves))]
            trials = [(k, t) for k, t in trials if t is not None]
            if not trials:
                break
            ws = score(*(np.stack([t[x] for _, t in trials])
                         for x in range(3)))
            up = np.flatnonzero(ws > cur + ACCEPT)
            if not len(up):
                break
            k, (c, b, p) = trials[up[0]]
            cur = float(ws[up[0]])
            improved = True
            pos = k + 1
    return c, b, p, cur


def climb_rows(n_workloads: int = 4, k: int = 4,
               multi_objective: bool = False,
               device: DeviceLike = None) -> List[Dict]:
    """Each workload's climb, unrounded: the workload, the grid's best
    weighted speedup, the climbed one and its allocation.  The search
    and every score run on ``device`` (None: the card), the scores in
    float64."""
    import torch

    from repro_torch.sim import memsys
    from repro_torch.sim.apps import app_fields, from_numpy, stack
    from repro_torch.sim.static_search import FIG5_FAMILIES, search_static
    from repro_torch.sim.workloads import random_workloads

    dev = resolve_device(device)
    fam = FIG5_FAMILY
    wls = random_workloads(n_workloads, 4, seed=7)
    res = search_static(wls, families={fam: FIG5_FAMILIES[fam]}, k=k,
                        multi_objective=multi_objective, device=dev)
    knee = res.knee_index(fam) if multi_objective else None
    grid = res.grids[fam]
    rows = []
    for wi, w in enumerate(wls):
        params = from_numpy(app_fields(stack(w)), dev)
        base = torch.as_tensor(res.baseline_ipc[wi], device=dev)

        def score(c, b, p):
            ss = memsys.evaluate(
                params, c, b, p,
                total_cache_units=grid.total_cache_units,
                total_bandwidth_gbps=grid.total_bandwidth_gbps, iters=40)
            return torch.mean(ss.ipc / base, dim=-1).cpu().numpy()

        seed_ids = [int(i) for i in res.topk_index[fam][wi] if i >= 0]
        if knee is not None:   # the knee leads; the front follows
            kn = int(knee[wi])
            seed_ids = [kn] + [i for i in seed_ids if i != kn]
        best_ws, best_cfg = -np.inf, None
        for idx in seed_ids:
            c, b, p, cur = climb(grid.cache[idx].copy(),
                                 grid.bandwidth[idx].copy(),
                                 grid.prefetch[idx].copy(), score, len(w))
            if cur > best_ws:
                best_ws = cur
                best_cfg = {"cache_units": c.tolist(),
                            "bandwidth_gbps": b.tolist(),
                            "prefetch_on": p.tolist()}
        rows.append({"workload": list(w),
                     "grid_best_ws": float(res.best_ws(fam)[wi]),
                     "refined_ws": best_ws, "config": best_cfg})
    return rows


def fig5_seeded_hillclimb(n_workloads: int = 4, k: int = 4,
                          force: bool = False,
                          multi_objective: bool = False,
                          device: DeviceLike = None,
                          results_dir: Optional[pathlib.Path] = None
                          ) -> Dict:
    """The reference's Fig. 5 record over :func:`climb_rows`, cached by
    its parameters."""
    dev = resolve_device(device)
    seed_mode = "pareto_knee" if multi_objective else "scalar_topk"
    path = _path(results_dir, "fig5_hillclimb", dev.type)
    if path.exists() and not force:
        cached = json.loads(path.read_text())
        if (cached.get("n_workloads") == n_workloads
                and cached.get("k_seeds") == k
                and cached.get("seed_mode") == seed_mode):
            return cached
    rows = [{"workload": r["workload"],
             "grid_best_ws": round(r["grid_best_ws"], 4),
             "refined_ws": round(r["refined_ws"], 4),
             "refine_gain": round(r["refined_ws"] / r["grid_best_ws"] - 1,
                                  4),
             "config": r["config"]}
            for r in climb_rows(n_workloads, k, multi_objective, dev)]
    rec = {"family": FIG5_FAMILY, "n_workloads": n_workloads, "k_seeds": k,
           "seed_mode": seed_mode,
           "mean_refine_gain": round(
               float(np.mean([r["refine_gain"] for r in rows])), 4),
           "rows": rows}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fig5-seed", action="store_true",
                    help="refine Fig. 5 static winners from the batched "
                         "search's top-k seeds")
    ap.add_argument("--workloads", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--multi-objective", action="store_true",
                    help="seed from the (ws, min-fairness) Pareto front, "
                         "knee point first")
    ap.add_argument("--device", default=None,
                    help="cpu for a \"cpu\" mesh and a CPU climb (default: "
                         "the card; raises without one)")
    ap.add_argument("--results", default=None,
                    help=f"directory of the records (default {OUT})")
    args = ap.parse_args(argv)

    if args.fig5_seed:
        rec = fig5_seeded_hillclimb(args.workloads, args.seeds,
                                    force=args.force,
                                    multi_objective=args.multi_objective,
                                    device=args.device,
                                    results_dir=args.results)
        print(f"fig5_hillclimb: mean refine gain {rec['mean_refine_gain']}"
              f" over {rec['n_workloads']} workloads "
              f"({rec['k_seeds']} seeds each, {rec['seed_mode']})",
              flush=True)
        for r in rec["rows"]:
            print(f"  {','.join(r['workload'])}: grid {r['grid_best_ws']}"
                  f" -> refined {r['refined_ws']} (+{r['refine_gain']})",
                  flush=True)
        return 0

    failures = 0
    for cell in [args.cell] if args.cell else list(CELLS):
        for v in [args.variant] if args.variant else list(VARIANTS[cell]):
            rec = run_variant(cell, v, force=args.force, device=args.device,
                              results_dir=args.results)
            if rec["status"] == "ok":
                print(f"{cell}/{v}: dom={rec['dominant']} "
                      f"bound={rec['bound_s']}s "
                      f"(C={rec['compute_s']} M={rec['memory_s']} "
                      f"X={rec['collective_s']}) frac="
                      f"{rec['roofline_fraction']} peak={rec['peak_gib']}GiB",
                      flush=True)
            else:
                failures += 1
                print(f"{cell}/{v}: ERROR {rec['error'][:150]}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
