"""The port's dry run on fake process groups, for the dry-run tests
(``tests/test_torch_dryrun.py``).  It imports the port only, and runs in
a process of its own: a fake group is process state.

``python tests/_torch_dryrun_run.py OUT RESULTS`` writes one JSON object
to OUT:

* ``count``: for each mesh of :data:`COUNT_MESHES`, one step of each case
  of :data:`COUNT_CASES` counted on a fake group of the mesh's size as
  rank 0, on ``meta`` tensors (``_torch_mesh_run.count_run``);
* ``make_mesh``: what ``distributed.make_mesh`` does on a fake group of
  4: the (2, 2) mesh's device type and shape, and the error a wrong size
  and a card mesh without a card raise;
* ``cells``: ``dryrun.run_cell`` on whisper-tiny ``decode_32k`` on the
  single pod (``device="cpu"``, records under RESULTS): the record, the
  record read back from the cache after a sentinel was written into it,
  the record with ``force``; a full-attention ``long_500k``'s skip; a
  cell whose build raises (recorded as data), and ``dryrun.main``'s exit
  code over it.
"""
from __future__ import annotations

import json
import sys

#: (name, arch, kind, rows, seq, microbatches) of each counted step.
COUNT_CASES = (("train", "qwen3-8b", "train", 8, 32, 2),
               ("prefill", "qwen3-8b", "prefill", 4, 64, 1))
#: Meshes of the counted steps, ("data", "model").
COUNT_MESHES = ((2, 2), (1, 1), (4, 1))
CELL = ("whisper-tiny", "decode_32k", "single")


def counts() -> dict:
    import math

    from _torch_mesh_run import count_run

    from repro_torch import configs
    from repro_torch import distributed as D

    out = {}
    for shape in COUNT_MESHES:
        D.start_fake_ranks(math.prod(shape))
        try:
            mesh = D.make_mesh(shape, ("data", "model"), "cpu")
            for name, arch, kind, rows, seq, mb in COUNT_CASES:
                cfg = configs.get_smoke(arch).with_mesh(shape[1], shape[0])
                out[f"{name}|{shape[0]}x{shape[1]}"] = count_run(
                    cfg, mesh, "cpu", kind, rows, seq, mb, meta=True)
        finally:
            D.end_ranks()
    return out


def meshes() -> dict:
    from repro_torch import distributed as D

    def error(call) -> str:
        try:
            call()
        except Exception as exc:   # noqa: BLE001 - the refusal is the result
            return f"{type(exc).__name__}: {exc}"
        return ""

    D.start_fake_ranks(4)
    try:
        mesh = D.make_mesh((2, 2), ("data", "model"), "cpu")
        return {"device_type": mesh.device_type,
                "shape": list(mesh.shape),
                "wrong_size": error(lambda: D.make_mesh(
                    (4, 4), ("data", "model"), "cpu")),
                "card": error(lambda: D.make_mesh(
                    (2, 2), ("data", "model"), "cuda"))}
    finally:
        D.end_ranks()


def cells(results: str) -> dict:
    from pathlib import Path

    from repro_torch.launch import dryrun

    arch, shape, mesh = CELL
    first = dryrun.run_cell(arch, shape, mesh, force=True, device="cpu",
                            results_dir=results)
    path = dryrun._cell_path(mesh, arch, shape, "cpu", results)
    path.write_text(json.dumps({**first, "sentinel": 1}))
    cached = dryrun.run_cell(arch, shape, mesh, device="cpu",
                             results_dir=results)
    forced = dryrun.run_cell(arch, shape, mesh, force=True, device="cpu",
                             results_dir=results)
    skip = dryrun.run_cell("qwen3-8b", "long_500k", mesh, force=True,
                           device="cpu", results_dir=results)

    def broken(*args, **kwargs):
        raise RuntimeError("build refused")

    real, dryrun.build_cell = dryrun.build_cell, broken
    try:
        error = dryrun.run_cell("yi-9b", "prefill_32k", mesh, force=True,
                                device="cpu", results_dir=results)
        code = dryrun.main(["--arch", "yi-9b", "--shape", "prefill_32k",
                            "--device", "cpu", "--force", "--results",
                            str(Path(results) / "cli")])
    finally:
        dryrun.build_cell = real
    return {"first": first, "cached": cached, "forced": forced,
            "skip": skip, "error": error, "error_exit": code,
            "files": sorted(p.name for p in Path(results).glob("*.json"))}


def main() -> None:
    out_path, results = sys.argv[1], sys.argv[2]
    out = {"count": counts(), "make_mesh": meshes(),
           "cells": cells(results)}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
