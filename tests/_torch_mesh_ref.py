"""The JAX package's training-mesh specs and memory figures, for the
port's mesh tests (``tests/test_torch_mesh_specs.py``).  Importing this
module imports neither JAX nor the JAX package; only the subprocess does.

The reference's spec functions (``launch/shardings.py``) read a mesh's
``axis_names`` and ``shape`` alone, so a stand-in mesh serves any shape
without devices; parameter and optimizer-state shapes come from
``jax.eval_shape``, so full configs allocate nothing.  The subprocess runs
with ``JAX_PLATFORMS=cpu`` and x64 off, and prints one JSON object:

* ``specs``: for each case ``"{config}|{smoke|full}|{mesh}"`` the flat
  specs (path -> entries) of ``param_specs``, of ``opt_state_specs`` for
  ``adamw``, ``adafactor`` and ``sgd``, of ``batch_specs`` for every
  batch of :data:`BATCH_ROWS` rows and of ``cache_specs`` for every cache
  of :data:`CACHE_ROWS` rows.  Each config runs as the reference's dry
  run sets it (``cfg.with_mesh(model_size, dp_size)``), a ``pure_dp``
  one under ``set_dp_axes(("pod", "data", "model"))``.
* ``spec_cases``: ``distributed.spec(*axes)`` for each of
  :data:`SPEC_AXES` on each mesh under each of :data:`DP_SETTINGS`.
* ``analytic``: ``analytic_memory`` for each config (as given and with
  the production mesh's ``with_mesh(16, 16)``) x ``train``/``decode`` x
  ``adamw``/``adafactor`` x :data:`CHIPS`.

Run as a script: ``python tests/_torch_mesh_ref.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

#: The meshes the specs are held on: (shape, axis names).
MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
#: Batch rows of ``batch_specs`` (the DP axes divide some, not others).
BATCH_ROWS = (1, 2, 3, 4, 8, 16, 32, 256)
#: Cache rows of ``cache_specs``, at :data:`CACHE_LEN` positions.
CACHE_ROWS = (1, 2, 8, 32)
CACHE_LEN = 64
#: Chip counts of ``analytic_memory``.
CHIPS = (1, 4, 256)
OPTIMIZERS = ("adamw", "adafactor", "sgd")
#: ``spec(*axes)`` under each DP-axes setting on each mesh: logical "dp",
#: tuples, repeats (an axis claimed once is dropped later) and axes the
#: mesh lacks.
DP_SETTINGS = (("pod", "data"), ("pod", "data", "model"), ("data",))
SPEC_AXES = (
    ("dp", None, None), ("dp", "model", None), ("dp", None, "model"),
    ("model", "dp"), (None, "model", "model"), (("data", "model"), "dp"),
    (("pod", "data"), None, "model"), ("pod", "data", "model"),
    ("dp", "dp"), ("expert", "model"), (), ("dp", ("model", "data")),
)


class StandInMesh:
    """What the spec functions read of a mesh: its axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def canonical(sp) -> list:
    """A spec's entries as JSON: None, a name, or a list of names."""
    return [list(e) if isinstance(e, tuple) else e for e in sp]


def batch_shapes(rows: int) -> dict:
    return {"tokens": (rows, 32), "labels": (rows, 32), "cur_len": ()}


def main() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.distributed import set_dp_axes, set_mesh, spec
    from repro.launch import shardings as sh
    from repro.launch.analytic import analytic_memory
    from repro.launch.mesh import dp_size, model_size
    from repro.models import build
    from repro.models.model import SHAPES
    from repro.optim.optimizers import make_optimizer

    def flat(tree) -> dict:
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        out = {}
        for path, leaf in leaves:
            key = "/".join(str(getattr(e, "key", getattr(e, "name",
                                                        getattr(e, "idx", e))))
                           for e in path)
            out[key] = canonical(leaf)
        return out

    specs = {}
    for name in configs.names():
        for kind, base in (("smoke", configs.get_smoke(name)),
                           ("full", configs.get(name))):
            for mesh_name, (shape, axes) in MESHES.items():
                mesh = StandInMesh(shape, axes)
                cfg = base.with_mesh(model_size(mesh), dp_size(mesh))
                set_dp_axes(sh.dp_axes_for(cfg))
                model = build(cfg)
                params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
                case = {"params": flat(sh.param_specs(cfg, params, mesh))}
                for opt in OPTIMIZERS:
                    init_opt, _ = make_optimizer(opt, 1e-3)
                    state = jax.eval_shape(init_opt, params)
                    case[opt] = flat(sh.opt_state_specs(
                        cfg, state, params, mesh, opt))
                case["batch"] = {
                    str(b): flat(sh.batch_specs(cfg, {
                        k: jax.ShapeDtypeStruct(s, jnp.int32)
                        for k, s in batch_shapes(b).items()}, mesh))
                    for b in BATCH_ROWS}
                case["cache"] = {
                    str(b): flat(sh.cache_specs(cfg, jax.eval_shape(
                        lambda b=b: model.init_cache(b, CACHE_LEN)), mesh))
                    for b in CACHE_ROWS}
                specs[f"{name}|{kind}|{mesh_name}"] = case
    set_dp_axes(("pod", "data"))

    spec_cases = []
    for dp in DP_SETTINGS:
        set_dp_axes(dp)
        for mesh_name, (shape, axes) in MESHES.items():
            set_mesh(StandInMesh(shape, axes))
            for a in SPEC_AXES:
                spec_cases.append({"dp": list(dp), "mesh": mesh_name,
                                   "axes": [list(x) if isinstance(x, tuple)
                                            else x for x in a],
                                   "spec": canonical(spec(*a))})
    set_mesh(None)
    set_dp_axes(("pod", "data"))

    analytic = []
    for name in configs.names():
        for mesh_model in (None, 16):
            cfg = configs.get(name)
            if mesh_model:
                cfg = cfg.with_mesh(mesh_model, 16)
            for shape in ("train_4k", "decode_32k"):
                for opt in ("adamw", "adafactor"):
                    for chips in CHIPS:
                        analytic.append({
                            "config": name, "mesh_model": mesh_model,
                            "shape": shape, "optimizer": opt,
                            "chips": chips,
                            "memory": analytic_memory(
                                cfg, SHAPES[shape], chips, opt)})
    json.dump({"specs": specs, "spec_cases": spec_cases,
               "analytic": analytic}, sys.stdout)


def reference() -> dict:
    """The reference's specs and figures, from one x64-off subprocess."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, __file__], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference mesh specs failed:\n{proc.stderr}")
    return json.loads(proc.stdout)


#: The reference gate on 8 forced host devices, a (2, 4) mesh
#: (``tests/test_distributed.py``'s SCRIPT), also writing each config's
#: initial parameters as a pickle of numpy arrays.
GATE_SCRIPT = r'''
import dataclasses, json, pickle, sys
import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.distributed import make_mesh, set_dp_axes, use_mesh
from repro.launch import shardings as sh
from repro.models import build
from repro.train.step import TrainStepConfig, build_train_step

out_dir = sys.argv[1]
mesh = make_mesh((2, 4), ("data", "model"))
results = {"n_devices": len(jax.devices())}
for arch in ["qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-1.3b"]:
    cfg = configs.get_smoke(arch)
    cfg = dataclasses.replace(
        cfg, param_dtype="float32", mesh_model=4,
        moe_groups=2 if cfg.n_experts else 1,
        seq_shard_activations=True, remat="full",
        n_heads=getattr(cfg, "n_heads", 4) or 0)
    model = build(cfg)
    tcfg = TrainStepConfig(optimizer="adamw", lr=1e-3, microbatches=2)
    init_opt, train_step = build_train_step(model, tcfg)
    set_dp_axes(sh.dp_axes_for(cfg))
    with use_mesh(mesh):
        params = model.init(jax.random.PRNGKey(0))
        with open(f"{out_dir}/{arch}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, params), f)
        pspec = sh.param_specs(cfg, params, mesh)
        params = jax.device_put(params, sh.named(pspec, mesh))
        opt = init_opt(params)
        step = jax.jit(train_step, donate_argnums=(0, 1))
        toks = jnp.zeros((8, 32), jnp.int32)
        batch = {"tokens": toks, "labels": toks}
        losses = []
        for _ in range(3):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
    results[arch] = losses
print("RESULT:" + json.dumps(results))
'''


def gate_reference(out_dir) -> dict:
    """The reference gate's losses on 8 forced host devices (x64 off);
    each config's initial parameters land in ``out_dir/{arch}.pkl``."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", GATE_SCRIPT, str(out_dir)],
                          env=env, capture_output=True, text=True,
                          timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"reference gate failed:\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT:")][0]
    return json.loads(line[len("RESULT:"):])


if __name__ == "__main__":
    main()
