"""The JAX package's dry-run figures, for the port's dry-run tests
(``tests/test_torch_dryrun.py``).  Importing this module imports neither
JAX nor the JAX package; only the subprocess does.

The subprocess runs with ``JAX_PLATFORMS=cpu``, x64 off and
:data:`DEVICES` forced host devices (the backend starts before
``repro.launch.dryrun``, whose first line asks for 512, is imported), and
prints one JSON object:

* ``cells``: for each of the ten configs x four ``SHAPES`` x the two
  meshes, the record the reference's ``run_cell`` starts (arch, shape,
  mesh, chips, kind, params, active params, status, and a skip's reason),
  got by running ``run_cell`` itself with the production mesh replaced by
  a stand-in of its shape, ``build_cell`` stopped before it builds
  anything and the cache directory a temporary one (nothing is compiled,
  and ``results/dryrun/`` is never written); beside it
  ``default_microbatches``, ``OPTIMIZER``'s choice, ``model_flops`` and
  ``analytic_memory``.
* ``wire``: ``hlo_parse``'s ring-model wire bytes for each of
  :data:`WIRE_CASES` (kind, per-device output elements of f32, group),
  from one collective instruction each; ``dtype_bytes``: its table.
* ``add``: ``CostSummary.add`` of :data:`ADD_CASE` three times over.
* ``prefill``: ``hlo_parse.analyze`` of the reference's jitted prefill of
  qwen3-8b's smoke config (``cfg.with_mesh(2, 2)``) on a (2, 2)
  ("data", "model") mesh at :data:`PREFILL_SPEC`, built by the reference
  dry run's own ``build_cell`` (the shape added to ``SHAPES`` in the
  subprocess): per-device FLOPs, collective counts and bytes, and the
  dots of the post-SPMD HLO by their output shapes.

Run as a script: ``python tests/_torch_dryrun_ref.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

DEVICES = 4
#: (kind, f32 elements of the per-device output, group size).
WIRE_CASES = [(kind, n, g)
              for kind in ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute")
              for n, g in ((1, 2), (1024, 4), (4096, 16), (12288, 32),
                           (3, 512))]
ADD_CASE = {"flops": 1.5e9, "hbm_bytes": 2.25e6,
            "collective_bytes": {"all-gather": 1024.0, "all-reduce": 8.0},
            "collective_wire_bytes": 768.5,
            "collective_count": {"all-gather": 3, "all-reduce": 1}}
#: The small prefill shape of the FLOP comparison: (name, seq, batch).
PREFILL_SPEC = ("tiny_prefill", 64, 4)
PREFILL_ARCH = "qwen3-8b"


class StandInMesh:
    """What the reference's mesh helpers read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.size = 1
        for n in shape:
            self.size *= n


def main() -> None:
    import dataclasses
    import re
    import tempfile

    import jax

    assert len(jax.devices()) == DEVICES, jax.devices()
    from repro import configs
    from repro.distributed import make_mesh, set_dp_axes, use_mesh
    from repro.launch import dryrun as dr
    from repro.launch import hlo_parse
    from repro.launch import shardings as sh
    from repro.launch.analytic import analytic_memory
    from repro.models import SHAPES, build
    from repro.models.model import ShapeSpec

    # -- (i) every cell's record, stopped before anything is built -----
    class Stop(Exception):
        pass

    def no_build(*args, **kwargs):
        raise Stop

    meshes = {"single": StandInMesh((16, 16), ("data", "model")),
              "multi": StandInMesh((2, 16, 16), ("pod", "data", "model"))}
    real_build_cell = dr.build_cell
    dr.make_production_mesh = lambda multi_pod=False: meshes[
        "multi" if multi_pod else "single"]
    dr.build_cell = no_build
    dr._write = lambda path, rec: None
    dr.RESULTS_DIR = Path(tempfile.mkdtemp(prefix="dryrun_ref_"))
    cells = []
    for mesh_kind, mesh in meshes.items():
        for arch in configs.names():
            for shape in SHAPES:
                rec = dr.run_cell(arch, shape, mesh_kind, force=True)
                for k in ("error", "traceback"):
                    rec.pop(k, None)
                cfg = configs.get(arch).with_mesh(dr.model_size(mesh),
                                                  dr.dp_size(mesh))
                opt = dr.OPTIMIZER.get(arch, "adamw")
                cells.append({
                    "record": rec,
                    "microbatches": dr.default_microbatches(cfg, shape),
                    "optimizer": opt,
                    "model_flops": dr.model_flops(cfg, SHAPES[shape],
                                                  mesh.size),
                    "analytic": analytic_memory(cfg, SHAPES[shape],
                                                mesh.size, opt)})

    # -- (ii) the ring model and CostSummary.add ------------------------
    costs = hlo_parse.HloModuleCosts("")
    wire = []
    for kind, n, g in WIRE_CASES:
        cost = hlo_parse.CostSummary()
        costs._collective(hlo_parse.Instr(
            "c", f"f32[{n}]{{0}}", kind,
            f"p), replica_groups=[{512 // g},{g}]<=[512]"), cost)
        wire.append({"kind": kind, "elements": n, "group": g,
                     "bytes": cost.collective_bytes[kind],
                     "wire": cost.collective_wire_bytes})
    total = hlo_parse.CostSummary()
    for _ in range(3):
        total.add(hlo_parse.CostSummary(**ADD_CASE), times=2.5)
    add = dataclasses.asdict(total)
    add["total_collective_bytes"] = total.total_collective_bytes

    # -- (v) the jitted prefill's per-device FLOPs ----------------------
    name, seq, rows = PREFILL_SPEC
    SHAPES[name] = ShapeSpec(name, seq, rows, "prefill")
    cfg = configs.get_smoke(PREFILL_ARCH).with_mesh(2, 2)
    mesh = make_mesh((2, 2), ("data", "model"))
    set_dp_axes(sh.dp_axes_for(cfg))
    with use_mesh(mesh):
        fn, args = real_build_cell(build(cfg), name, mesh, "adamw", 1)
        hlo = fn.lower(*args).compile().as_text()
    set_dp_axes(("pod", "data"))
    cost = hlo_parse.analyze(hlo)
    dots = {}
    for m in re.finditer(r"= (\w+\[[\d,]*\])\{?[\d,]*\}? dot\(", hlo):
        dots[m.group(1)] = dots.get(m.group(1), 0) + 1
    prefill = {"flops_per_device": cost.flops,
               "collective_counts": cost.collective_count,
               "collective_bytes": cost.collective_bytes,
               "dots": dots}

    json.dump({"cells": cells, "wire": wire,
               "dtype_bytes": hlo_parse.DTYPE_BYTES,
               "collectives": list(hlo_parse.COLLECTIVES),
               "add": add, "prefill": prefill}, sys.stdout)


def reference() -> dict:
    """The reference's figures, from one x64-off subprocess."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={DEVICES}",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, __file__], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference dry run failed:\n{proc.stderr}")
    return json.loads(proc.stdout)


if __name__ == "__main__":
    import jax

    jax.devices()      # the backend starts with DEVICES host devices
    main()
