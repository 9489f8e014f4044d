"""The dry run's FLOP count on the card (phase 20(a) of ``chip_smoke.py``
at smoke size): a smoke config's AdamW train step counted by
``repro_torch.launch.op_costs`` on a fake (1, 1) group with a ``"cuda"``
mesh, on ``meta`` tensors, equals ``FlopCounterMode``'s count of the same
step run for real on the card without a mesh, exactly; so do the global
FLOPs, and the peak estimate is at least the arguments' bytes.

The counts run in a subprocess (a fake group is process state).  Every
test needs an NVIDIA card (``cuda`` marker; skipped without one); on the
card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_dryrun_cuda.py``.  The file imports neither JAX nor the
JAX package.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-1.3b")
ROWS, SEQ = 4, 64

SCRIPT = r'''
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch import distributed as D
from repro_torch.launch import dryrun, op_costs
from repro_torch.launch import shardings as sh
from repro_torch.models import build
from repro_torch.models.model import ShapeSpec
from repro_torch.train import TrainStepConfig, build_train_step

archs, rows, seq = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
spec = ShapeSpec("count", seq, rows, "train")
out = {}
for arch in archs:
    cfg = configs.get_smoke(arch)
    D.start_fake_ranks(1)
    try:
        mesh = D.make_mesh((1, 1), ("data", "model"), "cuda")
        D.set_dp_axes(sh.dp_axes_for(cfg))
        with D.use_mesh(mesh):
            fn, args = dryrun.build_cell(dryrun.meta_model(cfg), spec, mesh,
                                         "adamw", 1)
            _, cost, counter = op_costs.trace(fn, *args)
    finally:
        D.set_dp_axes(D.DP_AXES)
        D.end_ranks()
    model = build(cfg, "cuda", seed=0)
    init_opt, step = build_train_step(model, TrainStepConfig())
    params = model.params
    opt = init_opt(params)
    batch = {k: torch.zeros_like(v, device="cuda")
             for k, v in model.input_specs(spec).items()}
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    torch.cuda.synchronize()
    out[arch] = {"counted": cost.flops, "global": cost.flops_global,
                 "real": float(fc.get_total_flops()),
                 "argument_bytes": counter.argument_bytes,
                 "peak_bytes": counter.peak_bytes}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the real step runs on it and the "
                    "fake group's mesh is a card mesh")
    tmp = tmp_path_factory.mktemp("dry")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(ARCHS), str(ROWS),
         str(SEQ)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "HOME": str(tmp), "TMPDIR": str(tmp)},
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_equal_the_real_step_on_the_card(counts, arch):
    got = counts[arch]
    assert got["counted"] == got["global"] == got["real"] > 0
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
