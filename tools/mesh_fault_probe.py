"""Where the port's mesh path asks DTensor for a redistribution that the
installed PyTorch may lack: dry-run cells with their depth cut, each
redistribution that turns a ``Shard`` into a ``Partial`` recorded with the
port's frames that asked for it, forward and backward.

  PYTHONPATH=src python tools/mesh_fault_probe.py \\
      zamba2-7b:prefill_32k:single:6 grok-1-314b:decode_32k:single:2

Each argument is ``arch:shape:mesh:layers``; a cell runs as the dry run
runs it (``repro_torch.launch.dryrun.run_cell``, a fake group of the
mesh's size, ``meta`` tensors, a ``"cpu"`` mesh so that no card is
needed) with its config cut to ``layers`` layers.  Prints one ``PROBE``
line a cell (status, error and its traceback's port frames, the
redistributions found) and writes them all to
``chiprun_out/mesh_fault_probe.json``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _port_frames(stack) -> list:
    return [f"{pathlib.Path(f.filename).name}:{f.lineno}:{f.name}"
            for f in stack if "repro_torch" in f.filename][-6:]


def install_recorder() -> collections.Counter:
    """Wrap DTensor's redistribution (the explicit one, the dispatcher's
    and the backward's) to count each ``Shard -> Partial`` request by
    placements, shape and asking frames."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    found: collections.Counter = collections.Counter()

    def note(kind, current, target, shape):
        if any(c.is_shard() and t.is_partial()
               for c, t in zip(current, target)):
            found[(kind, str(tuple(current)), str(tuple(target)),
                   str(tuple(shape)),
                   " < ".join(_port_frames(traceback.extract_stack())))] += 1

    local = redistribute.redistribute_local_tensor

    def redistribute_local_tensor(tensor, current_spec, target_spec, *a,
                                  **kw):
        note("forward", current_spec.placements, target_spec.placements,
             current_spec.shape)
        return local(tensor, current_spec, target_spec, *a, **kw)

    redistribute.redistribute_local_tensor = redistribute_local_tensor
    dispatch.redistribute_local_tensor = redistribute_local_tensor
    backward = redistribute.Redistribute.backward

    def redistribute_backward(ctx, grad_output, *rest):
        note("backward", grad_output.placements,
             ctx.current_spec.placements, grad_output.shape)
        return backward(ctx, grad_output, *rest)

    redistribute.Redistribute.backward = staticmethod(redistribute_backward)
    return found


def main(argv) -> int:
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun

    found = install_recorder()
    real_get = configs.get
    out = []
    with tempfile.TemporaryDirectory() as records:
        for cell in argv:
            arch, shape, mesh, layers = cell.split(":")
            configs.get = lambda name, n=int(layers): dataclasses.replace(
                real_get(name), n_layers=n)
            found.clear()
            t0 = time.time()
            try:
                rec = dryrun.run_cell(arch, shape, mesh, force=True,
                                      device="cpu", results_dir=records)
            finally:
                configs.get = real_get
            row = {"cell": cell, "torch": torch.__version__,
                   "status": rec["status"], "seconds": time.time() - t0,
                   "error": rec.get("error", ""),
                   "error_frames": [ln.strip() for ln in
                                    rec.get("traceback", "").splitlines()
                                    if "repro_torch" in ln][-8:],
                   "shard_to_partial": [
                       {"kind": k[0], "from": k[1], "to": k[2],
                        "shape": k[3], "frames": k[4], "count": n}
                       for k, n in found.items()]}
            if rec["status"] == "ok":
                row["peak_gib"] = (rec["memory"]["peak_estimate_bytes"]
                                   / 2 ** 30)
                row["flops_per_device"] = rec["counted"]["flops_per_device"]
            print("PROBE " + json.dumps(row), flush=True)
            out.append(row)
    dest = ROOT / "chiprun_out" / "mesh_fault_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0 if all(r["status"] == "ok" for r in out) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
