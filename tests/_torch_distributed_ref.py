"""Reference shard counts from the JAX package for the port's sharding
tests (``tests/test_torch_distributed.py``).  Importing this module
imports neither JAX nor the JAX package; only the subprocesses do.

The reference's ``row_shard_count`` and ``grid_shard_counts`` read
``jax.device_count()``, which is fixed once JAX starts: so each forced
device count runs in its own subprocess, started with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` and
``JAX_PLATFORMS=cpu``, as ``tests/test_timeline_fused.py`` runs its
forced-device scripts.  Each prints one JSON object: ``row`` (the count
for ``n_rows`` in ``ROWS``) and ``grid`` (``[K, M, a, b]`` for every
``K, M`` in ``GROUPS``).

Run as a script: ``python tests/_torch_distributed_ref.py`` (under the
flag).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, Sequence

SRC = Path(__file__).resolve().parents[1] / "src"

#: ``n_rows`` of ``row_shard_count`` and the ``K, M`` of
#: ``grid_shard_counts``.
ROWS = range(0, 33)
GROUPS = range(1, 12)


def main() -> None:
    import jax

    from repro import distributed

    json.dump({
        "devices": jax.device_count(),
        "row": [distributed.row_shard_count(n) for n in ROWS],
        "grid": [[K, M, *distributed.grid_shard_counts(K, M)]
                 for K in GROUPS for M in GROUPS],
    }, sys.stdout)


def reference(device_counts: Sequence[int]) -> Dict[int, dict]:
    """The reference's counts on each forced host device count, the
    subprocesses run side by side."""
    procs = {}
    for d in device_counts:
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                             + f" --xla_force_host_platform_device_count={d}"
                             ).strip(),
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")])}
        procs[d] = subprocess.Popen(
            [sys.executable, __file__], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for d, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"reference shard counts on {d} devices "
                               f"failed:\n{stderr}")
        out[d] = json.loads(stdout)
    return out


if __name__ == "__main__":
    main()
