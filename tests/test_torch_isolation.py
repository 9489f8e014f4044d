"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the ``repro`` package (nor ``msgpack`` or
``ml_dtypes``, which the reference's checkpoint needs), and the entry
points refuse to fall back to the CPU when no card is present.

Both checks run in a fresh interpreter: the first with ``jax``,
``jaxlib``, ``repro``, ``msgpack`` and ``ml_dtypes`` blocked on
``sys.meta_path`` (an import of them raises), the second with
``CUDA_VISIBLE_DEVICES`` empty, so it holds on a machine with a card too.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCKED_IMPORTS = r'''
import importlib, importlib.util, pkgutil, sys

class Blocker:
    """Refuse jax, jaxlib, the reference package (not repro_torch) and the
    reference checkpoint's msgpack and ml_dtypes."""
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
assert {"repro_torch.numpy_order", "repro_torch.sim.static_search",
        "repro_torch.sim.stream_sweep", "repro_torch.runtime.fault",
        "repro_torch.runtime.faultinject", "repro_torch.checkpoint.ckpt",
        "repro_torch.checkpoint._msgpack", "repro_torch.configs",
        "repro_torch.configs.qwen3_8b", "repro_torch.configs.zamba2_7b",
        "repro_torch.models", "repro_torch.models.config",
        "repro_torch.models.layers", "repro_torch.models.attention",
        "repro_torch.models.transformer", "repro_torch.models.ssm",
        "repro_torch.models.hybrid", "repro_torch.models.encdec",
        "repro_torch.models.model", "repro_torch.models.convert",
        "repro_torch.serving", "repro_torch.serving.kv_cache",
        "repro_torch.serving.engine", "repro_torch.serving.engine_graph",
        "repro_torch.launch", "repro_torch.launch.serve",
        "repro_torch.optim", "repro_torch.optim.optimizers",
        "repro_torch.optim.grad_compress", "repro_torch.optim.convert",
        "repro_torch.data", "repro_torch.data.pipeline",
        "repro_torch.train.step", "repro_torch.launch.train",
        "repro_torch.distributed", "repro_torch.launch.mesh",
        "repro_torch.launch.shardings", "repro_torch.launch.analytic",
        "repro_torch.launch.mesh_train"
        } <= set(names), names
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                 "ml_dtypes")]
assert not leaked, leaked
print(len(names))
'''

NO_CARD = r'''
import torch
assert not torch.cuda.is_available()
from repro_torch.core.cache_controller import lookahead_allocate
from repro_torch.sim import random_mixes, run_all_managers, run_sweep
from repro_torch.sim.characterization import sensitivity_table
from repro_torch.sim.static_search import search_static
from repro_torch.sim.stream_sweep import StreamConfig, run_stream
from repro_torch.runtime import (FusedTrainingPlant, TrainingPlant,
                                 run_fused_schedule)
from repro_torch.train import make_stream_plant_model
from repro_torch import configs
from repro_torch.models import build, params_from_jax
from repro_torch.launch import serve, train
from repro_torch.distributed import make_mesh, start_ranks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import (EngineConfig, GraphServingEngine,
                                 ServingEngine)
import numpy as np
step_fn, step_model = make_stream_plant_model(4, 48, 64.0, device="cpu")
cpu_model = build(configs.get_smoke("qwen3-8b"), device="cpu")
for call in (lambda: run_sweep(random_mixes(1, 16, seed=1), total_ms=1.0),
             lambda: lookahead_allocate(np.zeros((16, 257)), 256),
             lambda: run_all_managers(["lbm", "mcf"], total_ms=1.0),
             sensitivity_table,
             lambda: make_stream_plant_model(4, 48, 64.0),
             lambda: run_fused_schedule(step_model, n_clients=4,
                                        total_units=48, total_bandwidth=64.0,
                                        total_ms=10.0),
             lambda: FusedTrainingPlant(4, 48, 64.0, step_model),
             lambda: TrainingPlant(4, 48, 64.0, step_fn),
             lambda: search_static([["lbm", "mcf"]]),
             lambda: run_stream(StreamConfig(n_mixes=4, chunk_size=4,
                                             managers=("CBP",))),
             lambda: build(configs.get_smoke("qwen3-8b")),
             lambda: params_from_jax(configs.get_smoke("mamba2-1.3b"), {}),
             lambda: serve.main(["--engine", "graph"]),
             lambda: serve.main([]),
             lambda: train.train_loop("qwen3-8b", steps=1),
             lambda: train.main(["--steps", "1"]),
             lambda: make_mesh((1, 1), ("data", "model")),
             make_host_mesh,
             lambda: start_ranks("unused", 0, 1),
             lambda: GraphServingEngine(cpu_model, 4, EngineConfig()),
             lambda: ServingEngine(cpu_model, 4, EngineConfig())):
    try:
        call()
    except RuntimeError as exc:
        assert "device='cpu'" in str(exc), exc
    else:
        raise AssertionError("an entry point ran without a card")
print("raised")
'''


def _run(script, *args, env=None):
    env = {**os.environ, **(env or {}),
           "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_nothing_of_repro():
    proc = _run(BLOCKED_IMPORTS, str(ROOT / "chip_smoke.py"))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15   # every module was imported


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    proc = _run(NO_CARD, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "raised"


def test_train_launcher_refuses_without_a_card():
    """``python -m repro_torch.launch.train`` without ``--device cpu``
    exits non-zero on a machine with no card, and trains nothing."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert "final loss" not in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a card it exits non-zero and prints no result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied alone into an empty directory it fails too."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
