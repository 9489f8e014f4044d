"""Multi-pod dry run (counterpart of :mod:`repro.launch.dryrun`).

For every (architecture x input shape x mesh) cell: build the step (the
train step, prefill or a decode step by the shape's kind) on the
production mesh, with parameters, optimizer state, batch and cache placed
by :mod:`repro_torch.launch.shardings`, and record per device what it
costs, into one JSON a cell under ``results/dryrun_torch/``.

The reference lowers and compiles its step on 512 forced host devices and
reads XLA's analyses.  Here one process joins a fake process group of the
mesh's size as rank 0 (:func:`repro_torch.distributed.start_fake_ranks`),
every tensor lives on the ``meta`` device, and the step runs once under
:class:`repro_torch.launch.op_costs.CostCounter`: DTensor plans and issues
each collective, the fake group moves nothing, and no value is computed.
So ``trace_s`` (the traced step's host seconds) takes the place of the
reference's ``lower_s`` / ``compile_s``, ``counted`` of its ``parsed``,
and the per-device peak is the counter's live bytes of local storages
(``memory.peak_estimate_bytes``) beside the local bytes of the arguments
(``memory.argument_bytes``: parameter, optimizer-state, batch and cache
shards).  There is no ``xla_cost_analysis``: no compiler analyses the
step.  The roofline is the reference's at H100 constants.

A cell runs on a mesh of device type ``"cuda"`` by default, which raises
without a card (as every entry point of the port does); ``--device cpu``
gives a ``"cpu"`` mesh, where DTensor runs an all-to-all as an all-gather
(``counted.all_to_all_as_all_gather`` says how many).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch import distributed as D
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch.analytic import analytic_memory
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_costs import trace
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import SHAPES, Model, ShapeSpec, init_params
from repro_torch.train import TrainStepConfig, build_train_step

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")

# H100 SXM5 80GB roofline constants, at its 700 W limit (NVIDIA H100
# Tensor Core GPU datasheet).
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 B/s
LINK_BW = 450e9           # NVLink 4, B/s one direction: 18 links x 25 GB/s

# Large-model configs use a factored optimizer (the reference's table).
OPTIMIZER = {
    "grok-1-314b": "adafactor",
    "qwen3-moe-30b-a3b": "adafactor",
    "yi-34b": "adamw",
}

# Microbatching for the biggest activation footprints.
MICROBATCHES = {
    ("grok-1-314b", "train_4k"): 8,
    ("yi-34b", "train_4k"): 4,
    ("pixtral-12b", "train_4k"): 4,
}

CHIPS = {"single": 256, "multi": 512}
MODEL_AXIS = 16


def default_microbatches(cfg, shape_name: str) -> int:
    if SHAPES[shape_name].kind != "train":
        return 1
    mb = MICROBATCHES.get((cfg.name, shape_name))
    if mb:
        return mb
    return 2 if cfg.param_count() > 1e9 else 1


def _cell_path(mesh_kind: str, arch: str, shape: str,
               device_type: str = "cuda",
               results_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    return (pathlib.Path(results_dir or RESULTS_DIR)
            / f"{mesh_kind}__{arch}__{shape}__{device_type}.json")


def model_flops(cfg, spec, chips: int) -> float:
    """Spec formula: 6*N*D (train) / 2*N*D (inference), N_active for MoE."""
    n = cfg.active_param_count()
    if spec.kind == "train":
        d = spec.global_batch * spec.seq_len
        return 6.0 * n * d / chips
    if spec.kind == "prefill":
        d = spec.global_batch * spec.seq_len
        return 2.0 * n * d / chips
    return 2.0 * n * spec.global_batch / chips  # decode: one token/seq


def meta_model(cfg) -> Model:
    """``cfg``'s model with its parameters on the ``meta`` device: the
    layout alone, nothing allocated."""
    return Model(cfg, init_params(cfg, None, torch.device("meta")))


def build_cell(model: Model, spec: ShapeSpec, mesh, optimizer: str,
               microbatches: int):
    """``(fn, args)``: the cell's step and its arguments, placed on
    ``mesh`` (the ambient mesh, :func:`repro_torch.distributed.use_mesh`)
    as the reference's ``in_shardings`` place them.  ``model``'s
    parameters are placed by ``param_specs`` here unless they already
    are; the batch (and a decode's cache) are zeros on the model's device
    (``meta`` for a dry run)."""
    cfg = model.cfg
    if not any(D.is_dtensor(p) for p in model.parameters()):
        sh.place_model(model, mesh)
    params = model.params
    batch = {k: torch.zeros_like(v, device=model.device)
             for k, v in model.input_specs(spec).items()}
    batch = sh.place(batch, sh.batch_specs(cfg, batch, mesh), mesh)

    if spec.kind == "train":
        init_opt, train_step = build_train_step(model, TrainStepConfig(
            optimizer=optimizer, microbatches=microbatches))
        return train_step, (params, init_opt(params), batch)

    if spec.kind == "prefill":
        def prefill(params, batch):
            with D.mesh_context(), torch.no_grad():
                return model.prefill(batch)

        return prefill, (params, batch)

    # decode: one token a row against a bf16 cache of seq_len positions,
    # written in place (each rank into its own shard), so the step holds
    # one cache, as the reference donates its old one
    cache = model.init_cache(spec.global_batch, spec.seq_len,
                             dtype=torch.bfloat16)
    cache = sh.place(cache, sh.cache_specs(cfg, cache, mesh), mesh)

    def serve_step(params, cache, batch):
        with D.mesh_context(), torch.no_grad():
            return model.decode_step(cache, batch["tokens"],
                                     batch["cur_len"], inplace=True)

    return serve_step, (params, cache, batch)


def start_record(arch: str, shape_name: str, mesh_kind: str,
                 device_type: str) -> Tuple[ModelConfig, Dict]:
    """A cell's config (as the production mesh sets it) and the record
    :func:`run_cell` starts from: status ``"skip"`` with its reason where
    the model does not support the shape, else ``"pending"``."""
    chips = CHIPS[mesh_kind]
    # both production meshes have a model axis of 16 (launch/mesh.py)
    cfg = configs.get(arch).with_mesh(MODEL_AXIS, chips // MODEL_AXIS)
    rec: Dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips, "kind": SHAPES[shape_name].kind,
        "device": device_type,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "status": "pending",
    }
    if not meta_model(cfg).supports_shape(shape_name):
        rec["status"] = "skip"
        rec["reason"] = ("long_500k requires sub-quadratic sequence mixing;"
                         f" {arch} is pure full-attention (DESIGN.md §5)")
    return cfg, rec


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             force: bool = False, device: DeviceLike = None,
             results_dir: Optional[pathlib.Path] = None) -> Dict:
    """One cell's record, from the cache unless ``force``.  The cell runs
    as rank 0 of a fake group of the mesh's size on a mesh of ``device``'s
    type (None: the card's, which raises without one); errors are
    recorded as data.  Records go to ``results_dir`` (default
    :data:`RESULTS_DIR`)."""
    dev = resolve_device(device)
    out_path = _cell_path(mesh_kind, arch, shape_name, dev.type,
                          results_dir)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg, rec = start_record(arch, shape_name, mesh_kind, dev.type)
    if rec["status"] == "skip":
        _write(out_path, rec)
        return rec

    chips, spec = rec["chips"], SHAPES[shape_name]
    optimizer = OPTIMIZER.get(arch, "adamw")
    t0 = time.time()
    try:
        D.start_fake_ranks(chips)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device=dev)
        D.set_dp_axes(sh.dp_axes_for(cfg))
        with D.use_mesh(mesh):
            fn, args = build_cell(meta_model(cfg), spec, mesh, optimizer,
                                  default_microbatches(cfg, shape_name))
            t_build = time.time() - t0
            _, cost, counter = trace(fn, *args)
            t_trace = time.time() - t0 - t_build
        rec.update(record(cfg, spec, chips, optimizer, cost, counter))
        rec["build_s"] = round(t_build, 1)
        rec["trace_s"] = round(t_trace, 1)
    except Exception as exc:  # noqa: BLE001 — record failures as data
        rec["status"] = "error"
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        D.set_dp_axes(("pod", "data"))
        D.end_ranks()
    _write(out_path, rec)
    return rec


def record(cfg, spec, chips: int, optimizer: str, cost, counter) -> Dict:
    """The record's ``status``, ``memory``, ``counted`` and ``roofline``
    from one traced step (``cost`` and ``counter`` of
    :func:`repro_torch.launch.op_costs.trace`) on a mesh of ``chips``."""
    mf = model_flops(cfg, spec, chips)
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.hbm_bytes / HBM_BW
    collective_s = cost.total_collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    return {
        "status": "ok",
        "memory": {
            "argument_bytes": counter.argument_bytes,
            "peak_estimate_bytes": counter.peak_bytes,
            "analytic": analytic_memory(cfg, spec, chips, optimizer),
        },
        "counted": {
            "flops_per_device": cost.flops,
            "flops_global": cost.flops_global,
            "hbm_bytes_per_device": cost.hbm_bytes,
            "collective_bytes": cost.collective_bytes,
            "collective_counts": cost.collective_count,
            "collective_wire_bytes": cost.collective_wire_bytes,
            "total_collective_bytes": cost.total_collective_bytes,
            "all_to_all_as_all_gather": cost.all_to_all_as_all_gather,
        },
        "roofline": {
            **terms,
            "dominant": max(terms, key=terms.get),
            "model_flops_per_device": mf,
            "useful_flops_ratio": (mf / cost.flops if cost.flops else 0.0),
            "step_time_bound_s": max(terms.values()),
            "roofline_fraction": (compute_s / max(terms.values())
                                  if max(terms.values()) > 0 else 0.0),
        },
    }


def _write(path: pathlib.Path, rec: Dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=float))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu for a \"cpu\" mesh (default: the card's "
                         "device type; raises without one)")
    ap.add_argument("--results", default=None,
                    help=f"directory of the records (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = configs.names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, force=args.force,
                               device=args.device, results_dir=args.results)
                status = rec["status"]
                if status == "ok":
                    r, mem = rec["roofline"], rec["memory"]
                    print(f"[{mesh_kind}] {arch} x {shape}: OK "
                          f"trace={rec['trace_s']}s "
                          f"dom={r['dominant']} "
                          f"frac={r['roofline_fraction']:.2f} "
                          f"mem/dev={mem['peak_estimate_bytes']/2**30:.2f}GiB "
                          f"analytic="
                          f"{mem['analytic']['total_bytes']/2**30:.2f}GiB",
                          flush=True)
                elif status == "skip":
                    print(f"[{mesh_kind}] {arch} x {shape}: SKIP "
                          f"({rec['reason'][:60]}...)", flush=True)
                else:
                    failures += 1
                    print(f"[{mesh_kind}] {arch} x {shape}: ERROR "
                          f"{rec['error'][:160]}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
