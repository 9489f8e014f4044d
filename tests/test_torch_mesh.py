"""The reference's sharded-training gate (``tests/test_distributed.py``)
on the port: smoke configs changed as the reference changes them, AdamW
at lr 1e-3 with 2 microbatches, three steps, on a (2, 2) ("data",
"model") mesh of 4 gloo processes (ZeRO-1 over "data", tensor-parallel
and sequence-sharded over "model").

The mesh run (``tests/_torch_mesh_run.py``, in a subprocess) must train
as the reference's does, losses finite and falling, and equal the port's
one-process run of the same steps within the training bounds of the
one-process port against the JAX package (``tests/test_torch_train.py``):
losses within rtol 1e-4 / atol 1e-5; every parameter entry within 2 lr
steps and within rtol 1e-4 / atol ``1e-5 max(1, max|w|)`` on at least
99.9 % of entries.

qwen3-8b and qwen3-moe-30b-a3b run here (~35 s on 4 processes, most of
it DTensor planning its redistributions on the first step), and qwen3-8b
also with Adafactor (factored moments placed by their specs) and SGD;
mamba2-1.3b's first step plans for ~17 s more, so it runs in the slow
``tests/test_torch_mesh_slow.py`` with the reference's 8-process case.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_run import batches

from repro_torch import configs
from repro_torch.launch import mesh_train as mt

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b")
#: Every case: (arch, optimizer); qwen3-8b also with Adafactor and SGD.
CASES = {**{a: (a, "adamw") for a in ARCHS},
         "qwen3-8b/adafactor": ("qwen3-8b", "adafactor"),
         "qwen3-8b/sgd": ("qwen3-8b", "sgd")}
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-4, 1e-5, 0.999


def run_on_mesh(tmp_path, spec: dict, timeout: int) -> dict:
    """``tests/_torch_mesh_run.py`` on ``spec`` in a subprocess."""
    out = tmp_path / "mesh.pt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_run.py"),
         json.dumps(spec), str(out)],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(out, weights_only=False)


def one_process(arch: str, shape, batch: str = "tokens", steps: int = 3,
                optimizer: str = "adamw") -> dict:
    cfg = mt.gate_config(configs.get_smoke(arch), shape)
    return mt.train_on_mesh(cfg, None, batches(cfg, batch, steps),
                            device="cpu", optimizer=optimizer)


def assert_same_training(got: dict, want: dict, steps: int, what: str):
    gl, wl = np.asarray(got["losses"]), np.asarray(want["losses"])
    assert np.allclose(gl, wl, rtol=LOSS_RTOL, atol=LOSS_ATOL), (what, gl, wl)
    limit = 2 * mt.GATE_LR * steps
    outside = total = 0
    for i, (g, w) in enumerate(zip(got["params"], want["params"])):
        diff = np.abs(g - w)
        assert diff.max() <= limit, (what, i, diff.max())
        atol = PARAM_ATOL * max(1.0, float(np.abs(w).max()))
        outside += int((diff > atol + PARAM_RTOL * np.abs(w)).sum())
        total += w.size
    assert outside <= (1 - PARAM_SHARE) * total, (what, outside, total)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    spec = {"mesh": list(MESH), "train": [
        {"name": name, "arch": arch, "optimizer": opt, "batch": "tokens",
         "steps": mt.GATE_STEPS} for name, (arch, opt) in CASES.items()]}
    return run_on_mesh(tmp_path_factory.mktemp("mesh"), spec, timeout=300)


@pytest.mark.parametrize("case", CASES)
def test_sharded_training_loss_falls(mesh_runs, case):
    losses = mesh_runs[case]["losses"]
    assert len(losses) == mt.GATE_STEPS
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("case", CASES)
def test_sharded_training_equals_one_process(mesh_runs, case):
    arch, opt = CASES[case]
    assert_same_training(mesh_runs[case],
                         one_process(arch, MESH, optimizer=opt),
                         mt.GATE_STEPS, case)
