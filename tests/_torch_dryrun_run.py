"""The port's dry run on fake process groups, for the dry-run tests
(``tests/test_torch_dryrun.py``).  It imports the port only, and runs in
a process of its own: a fake group is process state.

``python tests/_torch_dryrun_run.py OUT RESULTS`` writes one JSON object
to OUT with ``count``, ``make_mesh`` and ``cells``, and ``python
tests/_torch_dryrun_run.py OUT faults`` one with ``moe`` and
``shard_to_partial``:

* ``count``: for each mesh of :data:`COUNT_MESHES`, one step of each case
  of :data:`COUNT_CASES` counted on a fake group of the mesh's size as
  rank 0, on ``meta`` tensors (``_torch_mesh_run.count_run``);
* ``moe``: :data:`MOE_CASE`'s train step counted on a fake
  :data:`MOE_MESH` group, or the error it raises;
* ``shard_to_partial``: what PyTorch 2.11 would have to turn from a
  ``Shard`` into a ``Partial`` in zamba2-7b's smoke train step and
  prefill on a fake (2, 2) group;
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
#: The counted steps whose residual stream is sequence-sharded.
SEQ_SHARDED = ("train",)
#: Meshes of the counted steps, ("data", "model").
COUNT_MESHES = ((2, 2), (1, 1), (4, 1))
CELL = ("whisper-tiny", "decode_32k", "single")
#: A MoE whose experts the model axis does not split (the grok-1-314b
#: layout of few big experts: TP over d_ff, FSDP over d), trained at one
#: row a rank a microbatch on a (2, 4) mesh: (overrides of grok-1-314b's
#: smoke config, rows, seq, microbatches).
MOE_MESH = (2, 4)
MOE_CASE = (dict(n_experts=2, top_k=2, d_model=16, d_ff=2048), 4, 16, 2)
#: zamba2-7b's smoke steps searched for a Shard -> Partial redistribution:
#: (kind, rows, seq, microbatches).
HYBRID_STEPS = (("train", 8, 32, 2), ("prefill", 4, 64, 1))


def counts() -> dict:
    import math

    from _torch_mesh_run import count_config, count_run

    from repro_torch import distributed as D

    out = {}
    for shape in COUNT_MESHES:
        D.start_fake_ranks(math.prod(shape))
        try:
            mesh = D.make_mesh(shape, ("data", "model"), "cpu")
            for name, arch, kind, rows, seq, mb in COUNT_CASES:
                cfg = count_config(arch, shape, name in SEQ_SHARDED)
                out[f"{name}|{shape[0]}x{shape[1]}"] = count_run(
                    cfg, mesh, "cpu", kind, rows, seq, mb, meta=True)
        finally:
            D.end_ranks()
    return out


def moe_count() -> dict:
    """The MoE case counted on a fake (2, 4) group: its status, and its
    error where it raises."""
    import dataclasses
    import math

    from _torch_mesh_run import count_run

    from repro_torch import configs
    from repro_torch import distributed as D

    over, rows, seq, mb = MOE_CASE
    cfg = dataclasses.replace(configs.get_smoke("grok-1-314b"), **over
                              ).with_mesh(MOE_MESH[1], MOE_MESH[0])
    D.start_fake_ranks(math.prod(MOE_MESH))
    try:
        mesh = D.make_mesh(MOE_MESH, ("data", "model"), "cpu")
        run = count_run(cfg, mesh, "cpu", "train", rows, seq, mb, meta=True)
        return {"moe_ep": cfg.moe_ep, "flops": run["cost"]["flops"],
                "error": ""}
    except Exception as exc:   # noqa: BLE001 - the error is the result
        return {"moe_ep": cfg.moe_ep, "flops": 0.0,
                "error": f"{type(exc).__name__}: {exc}"}
    finally:
        D.end_ranks()


def shard_to_partial() -> dict:
    """What PyTorch 2.11 (which cannot turn a ``Shard`` into a
    ``Partial``) would have to resolve in zamba2-7b's smoke steps on a
    fake (2, 2) group, its residual stream sequence-sharded as in the full
    config: each forward redistribution from a ``Shard`` to a ``Partial``
    and each forward DTensor op whose inputs mix a ``Partial`` and a
    ``Shard`` on one mesh dimension (2.11 may meet it by the former), by
    op and placements: ``{kind: [...]}``."""
    import dataclasses

    import torch
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import ShapeSpec

    found = []

    def forward():
        return torch._C._current_autograd_node() is None

    class Mixed(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ts = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(t, DTensor)]
            if forward() and len(ts) > 1:
                for j in range(ts[0].device_mesh.ndim):
                    ps = [t.placements[j] for t in ts]
                    if (any(p.is_partial() for p in ps)
                            and any(p.is_shard() for p in ps)):
                        found.append((str(func), [str(t.placements)
                                                  for t in ts]))
            return func(*args, **kwargs)

    local = redistribute.redistribute_local_tensor

    def redistribute_local_tensor(tensor, current_spec, target_spec, *a,
                                  **kw):
        if forward() and any(c.is_shard() and t.is_partial() for c, t in
                             zip(current_spec.placements,
                                 target_spec.placements)):
            found.append(("redistribute", [str(current_spec.placements),
                                           str(target_spec.placements)]))
        return local(tensor, current_spec, target_spec, *a, **kw)

    redistribute.redistribute_local_tensor = redistribute_local_tensor
    dispatch.redistribute_local_tensor = redistribute_local_tensor
    cfg = dataclasses.replace(configs.get_smoke("zamba2-7b").with_mesh(2, 2),
                              seq_shard_activations=True)
    out = {}
    D.start_fake_ranks(4)
    try:
        mesh = D.make_mesh((2, 2), ("data", "model"), "cpu")
        D.set_dp_axes(sh.dp_axes_for(cfg))
        for kind, rows, seq, mb in HYBRID_STEPS:
            found.clear()
            with D.use_mesh(mesh):
                fn, args = dryrun.build_cell(
                    dryrun.meta_model(cfg), ShapeSpec("probe", seq, rows,
                                                      kind),
                    mesh, "adamw", mb)
                with Mixed():
                    fn(*args)
            out[kind] = list(found)
    finally:
        D.set_dp_axes(D.DP_AXES)
        D.end_ranks()
        redistribute.redistribute_local_tensor = local
        dispatch.redistribute_local_tensor = local
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
    if results == "faults":
        out = {"moe": moe_count(), "shard_to_partial": shard_to_partial()}
    else:
        out = {"count": counts(), "make_mesh": meshes(),
               "cells": cells(results)}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
