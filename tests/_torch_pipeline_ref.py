"""The JAX package's pipeline (``repro.train.pipeline.pipeline_apply``)
on the pipeline tests' cases, for ``tests/test_torch_pipeline.py``.
Importing this module imports neither JAX nor the JAX package; only the
subprocess does.

Each case is the reference gate's (``tests/test_pipeline.py``): a stack
of ``layers`` (D, D) matrices, ``x -> tanh(x @ w)`` a layer, split into
``S`` stages (the "pod" size of a ("pod", "data") mesh of ``mesh``), run
on ``n_micro`` microbatches of (8, D), with weights (times 0.3) and
inputs drawn by numpy from the case's seed.  The subprocess forces 4 host
devices with x64 off, runs each case's pipeline on the first
``prod(mesh)`` of them (jitted) and writes, to an ``.npz``, its outputs
and ``jax.grad`` of ``sum(out ** 2)`` for the stacked weights (as ``(L,
D, D)``) and for the stream.

Run as a script: ``python tests/_torch_pipeline_ref.py OUT.npz``.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"

D_MODEL, MB_ROWS = 16, 8
AXES = ("pod", "data")
#: name -> ("pod", "data") mesh shape, layers, microbatches, seed.  The
#: reference gate is ``gate_2x2``; ``n1``, ``n3`` and ``s4_n2`` have fewer
#: microbatches than stages or a stage ends its ticks in a bubble.
CASES = {
    "gate_2x2": {"mesh": (2, 2), "layers": 4, "n_micro": 4, "seed": 0},
    "s2_2x1": {"mesh": (2, 1), "layers": 4, "n_micro": 4, "seed": 1},
    "s4_4x1": {"mesh": (4, 1), "layers": 8, "n_micro": 4, "seed": 2},
    "s2_n1": {"mesh": (2, 1), "layers": 4, "n_micro": 1, "seed": 3},
    "s2_n3": {"mesh": (2, 1), "layers": 4, "n_micro": 3, "seed": 4},
    "s4_n2": {"mesh": (4, 1), "layers": 8, "n_micro": 2, "seed": 5},
    "s1_1x2": {"mesh": (1, 2), "layers": 4, "n_micro": 4, "seed": 6},
    "s1_1x1": {"mesh": (1, 1), "layers": 4, "n_micro": 4, "seed": 7},
}


def inputs(name: str):
    """The case's stacked weights ``(L, D, D)`` and stream ``(n_micro, 8,
    D)``, float32."""
    case = CASES[name]
    rng = np.random.default_rng(case["seed"])
    ws = (rng.standard_normal((case["layers"], D_MODEL, D_MODEL))
          * 0.3).astype(np.float32)
    x = rng.standard_normal(
        (case["n_micro"], MB_ROWS, D_MODEL)).astype(np.float32)
    return ws, x


def main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp

    from repro.distributed import make_mesh
    from repro.train.pipeline import pipeline_apply

    def stage_fn(params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, params)[0]

    arrays = {}
    for name, case in CASES.items():
        shape = case["mesh"]
        mesh = make_mesh(shape, AXES,
                         devices=jax.devices()[:math.prod(shape)])
        ws, x = inputs(name)
        stages = jnp.asarray(ws).reshape(shape[0], -1, D_MODEL, D_MODEL)

        def loss(w, xs):
            o = pipeline_apply(stage_fn, w, xs, mesh, axis="pod")
            return jnp.sum(o ** 2), o

        (_, o), (dw, dx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(stages, jnp.asarray(x))
        arrays[f"{name}/out"] = np.asarray(o)
        arrays[f"{name}/dw"] = np.asarray(dw).reshape(ws.shape)
        arrays[f"{name}/dx"] = np.asarray(dx)
    np.savez(out, **arrays)


def start(out) -> subprocess.Popen:
    """The reference run writing ``out``, started in its own session (x64
    off, the CPU); :func:`finish` waits for it."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    return launch([sys.executable, __file__, str(out)], env, f"{out}.log")


def launch(argv, env: dict, log) -> subprocess.Popen:
    """``argv`` in a session of its own, its output to the file ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen(argv, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def finish(proc: subprocess.Popen, out, timeout: float) -> dict:
    """The reference's arrays, ``{case: {"out", "dw", "dx"}}``; the
    process group is killed past ``timeout`` seconds."""
    wait(proc, timeout, f"{out}.log")
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    return {name: {k: arrays[f"{name}/{k}"] for k in ("out", "dw", "dx")}
            for name in CASES}


def wait(proc: subprocess.Popen, timeout: float, log) -> None:
    """Wait for a process of :func:`launch`; past ``timeout`` seconds kill
    its session (every process it started) and raise; raise with the end
    of its ``log`` if it failed."""
    import signal

    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise RuntimeError(f"{proc.args} did not end in {timeout} s:\n"
                           f"{Path(log).read_text()[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args} failed:\n"
                           f"{Path(log).read_text()[-4000:]}")


if __name__ == "__main__":
    main(sys.argv[1])
