"""Reference values from the JAX package's training stack for the port's
training tests (``tests/test_torch_train.py``,
``tests/test_torch_train_parts.py``), and the inputs both sides draw.
Importing this module imports neither JAX nor the JAX package; only the
subprocesses do.

The reference runs with x64 OFF, as ``tests/_torch_model_ref.py`` runs
its models, in subprocesses side by side (:func:`train_reference`), each
running some of these jobs and writing one ``.npz``:

* ``grads:<case>`` — ``jax.value_and_grad(model.loss)`` jitted, on
  ``Model.init(PRNGKey(PARAM_KEY[case]))`` parameters and the model
  tests' batch (:func:`_torch_model_ref.model_inputs`), and its one-ulp
  spread: the largest distance, per leaf, to the same jitted gradient
  with every parameter one ulp up;
* ``traj:<run>`` — :data:`TRAJ_STEPS` steps of a jitted
  ``build_train_step`` from ``PRNGKey(0)`` parameters on
  :func:`train_batches`: the losses, the final parameters and optimizer
  state (zamba2-7b also from parameters one ulp up: the spreads of its
  losses and, per leaf, of its final parameters);
* ``optim`` — ``adamw_update`` (f32 and bf16 parameters),
  ``adafactor_update`` and ``"sgd"`` jitted on :func:`optim_inputs`,
  after 1 and 3 updates;
* ``compress`` — ``compress_grads``/``decompress_grads`` as written (not
  jitted) on ``tests/test_substrate.py``'s cases: 50 error-feedback
  rounds of a (64, 64) gradient, and a (16, 16) gradient for every seed
  in ``0..1000``;
* ``ckpt`` — ``launch.train.train_loop``: mamba2-1.3b for 10 steps with a
  checkpoint every 5 into ``<out dir>/ref_ckpt``, then its own
  continuation to 16 steps from a copy; and qwen3-8b with Adafactor for
  2 steps into ``<out dir>/ref_ckpt_adafactor``.

Run as a script: ``python tests/_torch_train_ref.py OUT.npz JOB...``.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

from _torch_model_ref import (
    CASES,
    PARAM_KEY,
    case_config,
    flatten,
    model_inputs,
    unflatten,
)

SRC = Path(__file__).resolve().parents[1] / "src"

#: The gradient cases: the ten smoke configs and "moe_overflow" (R3),
#: MoE drop-free at capacity factor 8.0 as in the model tests.
GRAD_CASES = tuple(c for c in CASES if c != "int8")

#: Trajectories: run -> (arch, TrainStepConfig overrides).
TRAJ_RUNS = {
    "qwen3-8b": ("qwen3-8b", {}),
    "qwen3-8b_microbatches2": ("qwen3-8b", {"microbatches": 2}),
    "qwen3-8b_adafactor": ("qwen3-8b", {"optimizer": "adafactor"}),
    "qwen3-8b_sgd": ("qwen3-8b", {"optimizer": "sgd"}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "zamba2-7b": ("zamba2-7b", {}),
    "whisper-tiny": ("whisper-tiny", {}),
}
TRAJ_STEPS, TRAJ_B, TRAJ_S, TRAJ_LR, TRAJ_SEED = 5, 4, 32, 1e-3, 1
#: Runs whose loss spread (parameters one ulp up) is measured too (R4).
SPREAD_RUNS = ("zamba2-7b",)

#: The optimizer cases on identical inputs, and their learning rate.
OPTIM_KINDS = ("adamw", "adamw_bf16", "adafactor", "sgd")
OPTIM_LR = 1e-2
OPTIM_UPDATES = (1, 3)

#: ``compress_grads`` seeds of the sweep (``tests/test_substrate.py``'s
#: ``st.integers(0, 1000)``) and rounds of the error-feedback case.
COMPRESS_SEEDS = 1001
COMPRESS_ROUNDS = 50

#: The checkpointed loop (``tests/test_train_loop.py:21``).
CKPT_ARCH, CKPT_B, CKPT_S, CKPT_EVERY = "mamba2-1.3b", 2, 32, 5
CKPT_FIRST, CKPT_LAST = 10, 16

#: The subprocesses of each test module, about equal in compile time.
TRAIN_GROUPS = (
    ("grads:whisper-tiny", "grads:pixtral-12b", "grads:qwen3-8b",
     "grads:yi-9b", "grads:yi-34b", "grads:minitron-8b",
     "traj:qwen3-8b", "traj:qwen3-8b_microbatches2",
     "traj:qwen3-8b_adafactor", "traj:qwen3-8b_sgd"),
    ("grads:qwen3-moe-30b-a3b", "grads:grok-1-314b", "grads:moe_overflow",
     "grads:mamba2-1.3b", "traj:qwen3-moe-30b-a3b", "traj:mamba2-1.3b",
     "ckpt"),
    ("grads:zamba2-7b", "traj:zamba2-7b", "traj:whisper-tiny"),
)
PARTS_GROUPS = (("optim", "compress"),)


# ------------------------------------------------------------------ #
# inputs both sides draw (numpy only)
# ------------------------------------------------------------------ #


def traj_config(configs, run: str):
    """The run's config from ``configs`` (``repro.configs`` or
    ``repro_torch.configs``): the model tests' case config."""
    return case_config(configs, TRAJ_RUNS[run][0])


def train_batches(SyntheticTokens, cfg, steps: int = TRAJ_STEPS,
                  b: int = TRAJ_B, s: int = TRAJ_S,
                  seed: int = TRAJ_SEED) -> list:
    """``steps`` batches of ``SyntheticTokens(b, s, vocab, seed)`` (either
    package's), with frames for the encoder-decoder drawn from
    ``default_rng((seed, 1000 + i))``."""
    src = SyntheticTokens(b, s, cfg.vocab_size, seed=seed)
    out = []
    for i in range(steps):
        batch = next(src)
        if cfg.family == "encdec":
            batch["frames"] = np.random.default_rng(
                (seed, 1000 + i)).standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def optim_inputs(seed: int = 7):
    """f32 parameters (a matrix, a vector, a stack of matrices and a
    column, which Adafactor does not factor) and three gradients, the
    second with a global norm past the clip."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 4), "b": (4,), "s": (2, 3, 5), "c": (6, 1)}
    params = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(v)).astype(np.float32)
              for k, v in shapes.items()} for scale in (0.05, 2.0, 0.3)]
    return params, grads


def compress_ef_input() -> np.ndarray:
    """``test_grad_compression_error_feedback_unbiased``'s gradient."""
    rng = np.random.default_rng(0)
    return rng.normal(size=(64, 64)).astype(np.float32)


def compress_seed_input(seed: int) -> np.ndarray:
    """``test_grad_compression_bounded_error``'s gradient."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(16, 16)).astype(np.float32)


def flatten_state(state, prefix: str = "opt") -> dict:
    """An ``OptState`` (either package's, numpy-readable leaves) as flat
    ``{prefix/field/path: array}``; an Adafactor moment tuple's entries
    are ``.../#i``."""
    out = {f"{prefix}/step": np.asarray(state.step)}
    for field in ("master", "m", "v"):
        tree = getattr(state, field)
        if tree is None:
            continue
        for path, leaf in flatten(_tuples_as_dicts(tree)).items():
            out[f"{prefix}/{field}/{path}"] = leaf
    return out


def _tuples_as_dicts(tree):
    if isinstance(tree, dict):
        return {k: _tuples_as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {f"#{i}": np.asarray(v) for i, v in enumerate(tree)}
    return tree


def _dicts_as_tuples(tree):
    if isinstance(tree, dict):
        if tree and all(k.startswith("#") for k in tree):
            return tuple(tree[f"#{i}"] for i in range(len(tree)))
        return {k: _dicts_as_tuples(v) for k, v in tree.items()}
    return tree


def unflatten_state(flat: dict):
    """:func:`flatten_state`'s tree (without the prefix) back as an object
    with ``step``, ``master``, ``m`` and ``v``, for
    ``repro_torch.optim.convert.opt_state_from_jax``."""
    fields = {f: None for f in ("master", "m", "v")}
    for f in fields:
        sub = {k[len(f) + 1:]: v for k, v in flat.items()
               if k.startswith(f + "/")}
        if sub:
            fields[f] = _dicts_as_tuples(unflatten(sub))
    return types.SimpleNamespace(step=flat["step"], **fields)


def training_plant_step_fn(total_units: int, total_bw: float):
    """``tests/test_train_loop.py:39``'s plant, unchanged (numpy), over
    the port's ``StreamKnobs`` (tensors on the plant's device, read back
    to the host); shared by ``tests/test_torch_train_parts.py`` and
    ``chip_smoke.py`` phase 16(d)."""
    def step_fn(duration_ms, knobs):
        u = np.asarray(knobs.buffer_units.cpu(), dtype=np.float64)
        bw = np.asarray(knobs.bandwidth_mbps.cpu(), dtype=np.float64)
        pf = np.asarray(knobs.prefetch_on.cpu(), dtype=np.float64)
        # stream 0: concave gain in buffers, big prefetch benefit
        tp0 = 1.0 + 0.5 * np.log1p(u[0]) + 0.4 * pf[0]
        # stream 1: throughput ~ bandwidth, indifferent to buffers
        tp1 = 0.2 + bw[1] / total_bw
        wait = np.array([5.0 / max(bw[0], 1.0), 40.0 / max(bw[1], 1.0)])
        curves = np.stack([
            2.0 * np.log1p(np.arange(total_units + 1)),      # concave
            0.02 * np.arange(total_units + 1),               # ~flat
        ])
        return np.array([tp0, tp1]), wait, curves
    return step_fn


# ------------------------------------------------------------------ #
# the test side
# ------------------------------------------------------------------ #


def train_reference(tmp_path_factory, groups) -> dict:
    """Run ``groups`` of jobs in x64-off JAX subprocesses side by side;
    return ``{job: {name: array or nested dict}}`` and, under ``"dir"``,
    the directory the ``ckpt`` job wrote into."""
    tmp = tmp_path_factory.mktemp("jax_train_ref")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(
        [str(SRC), str(Path(__file__).parent),
         os.environ.get("PYTHONPATH", "")])})
    runs = []
    for i, group in enumerate(groups):
        out = tmp / f"train{i}.npz"
        runs.append((out, subprocess.Popen(
            [sys.executable, __file__, str(out), *group], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    flat = {}
    for out, proc in runs:
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX train reference failed:\n{stdout}\n"
                               f"{stderr}")
        with np.load(out) as data:
            flat.update(data)
    jobs: dict = {"dir": tmp}
    for path, value in flat.items():
        job, rest = path.split("|", 1)
        jobs.setdefault(job, {})[rest] = value
    return jobs


# ------------------------------------------------------------------ #
# the subprocess (x64 off)
# ------------------------------------------------------------------ #


def _nudged(jax, jnp, tree):
    return jax.tree.map(
        lambda a: jnp.nextafter(a, jnp.inf)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _grads(jax, jnp, case: str) -> dict:
    from repro import configs
    from repro.models import build

    cfg = case_config(configs, case)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(PARAM_KEY[case]))
    batch = {k: jnp.asarray(v)
             for k, v in model_inputs(cfg)["batch"].items()}
    vg = jax.jit(jax.value_and_grad(model.loss))
    loss, grads = vg(params, batch)
    loss1, grads1 = vg(_nudged(jax, jnp, params), batch)
    spread = jax.tree.map(lambda a, b: jnp.max(jnp.abs(a - b)), grads,
                          grads1)
    out = {"loss": loss, "spread/loss": jnp.abs(loss1 - loss)}
    out.update({f"grads/{k}": v for k, v in flatten(grads).items()})
    out.update({f"spread/grads/{k}": v for k, v in flatten(spread).items()})
    out.update({f"params/{k}": v for k, v in flatten(params).items()})
    return out


def _trajectory(jax, jnp, run: str) -> dict:
    from repro import configs
    from repro.data import SyntheticTokens
    from repro.models import build
    from repro.train.step import TrainStepConfig, build_train_step

    cfg = traj_config(configs, run)
    model = build(cfg)
    tcfg = TrainStepConfig(lr=TRAJ_LR, **TRAJ_RUNS[run][1])
    init_opt, train_step = build_train_step(model, tcfg)
    step = jax.jit(train_step)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in train_batches(SyntheticTokens, cfg)]
    params0 = model.init(jax.random.PRNGKey(0))

    def run_from(params):
        opt = init_opt(params)
        losses = []
        for batch in batches:
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"])
        return np.asarray(losses), params, opt

    losses, params, opt = run_from(params0)
    out = {"losses": losses}
    if run in SPREAD_RUNS:
        losses1, params1, _ = run_from(_nudged(jax, jnp, params0))
        out["spread/losses"] = np.abs(losses1 - losses)
        spread = jax.tree.map(lambda a, b: jnp.max(jnp.abs(a - b)),
                              params, params1)
        out.update({f"spread/final/{k}": v
                    for k, v in flatten(spread).items()})
    out.update({f"init/{k}": v for k, v in flatten(params0).items()})
    out.update({f"final/{k}": v for k, v in flatten(params).items()})
    out.update(flatten_state(opt))
    return out


def _optim(jax, jnp) -> dict:
    import functools

    from repro.optim import (
        adafactor_init,
        adafactor_update,
        adamw_init,
        adamw_update,
        make_optimizer,
    )

    params_np, grads_np = optim_inputs()
    out = {}
    for kind in OPTIM_KINDS:
        dtype = jnp.bfloat16 if kind == "adamw_bf16" else jnp.float32
        params = {k: jnp.asarray(v).astype(dtype)
                  for k, v in params_np.items()}
        grads = [{k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
                 for g in grads_np]
        if kind.startswith("adamw"):
            init = adamw_init
            upd = functools.partial(adamw_update, lr=OPTIM_LR)
        elif kind == "adafactor":
            init = adafactor_init
            upd = functools.partial(adafactor_update, lr=OPTIM_LR)
        else:
            init, upd = make_optimizer("sgd", OPTIM_LR)
        upd = jax.jit(upd)
        state = init(params)
        for n in range(1, max(OPTIM_UPDATES) + 1):
            params, state = upd(params, grads[n - 1], state)
            if n in OPTIM_UPDATES:
                tag = f"{kind}/{n}"
                out.update({f"{tag}/params/{k}": v
                            for k, v in flatten(params).items()})
                out.update(flatten_state(state, f"{tag}/opt"))
    return out


def _compress(jax, jnp) -> dict:
    from repro.optim import compress_grads, decompress_grads

    g = {"w": jnp.asarray(compress_ef_input())}
    err, rounds = None, {"q": [], "scales": [], "err": [], "deq": []}
    for _ in range(COMPRESS_ROUNDS):
        q, scales, err = compress_grads(g, err)
        rounds["q"].append(q["w"])
        rounds["scales"].append(scales["w"])
        rounds["err"].append(err["w"])
        rounds["deq"].append(decompress_grads(q, scales)["w"])
    out = {f"ef/{k}": np.stack([np.asarray(x) for x in v])
           for k, v in rounds.items()}
    seeds = {"q": [], "scales": [], "err": []}
    for seed in range(COMPRESS_SEEDS):
        q, scales, err = compress_grads(
            {"w": jnp.asarray(compress_seed_input(seed))})
        seeds["q"].append(q["w"])
        seeds["scales"].append(scales["w"])
        seeds["err"].append(err["w"])
    out.update({f"seeds/{k}": np.stack([np.asarray(x) for x in v])
                for k, v in seeds.items()})
    return out


def _ckpt(jax, out_dir: Path) -> dict:
    from repro import configs
    from repro.launch.train import train_loop
    from repro.models import build

    first = out_dir / "ref_ckpt"
    kw = dict(batch=CKPT_B, seq=CKPT_S, ckpt_every=CKPT_EVERY, log_every=0,
              cbp_manage=False)
    out1 = train_loop(CKPT_ARCH, steps=CKPT_FIRST, ckpt_dir=first, **kw)
    cont = out_dir / "ref_ckpt_continued"
    shutil.copytree(first, cont)
    out2 = train_loop(CKPT_ARCH, steps=CKPT_LAST, ckpt_dir=cont, **kw)
    train_loop("qwen3-8b", steps=2, batch=2, seq=16, optimizer="adafactor",
               ckpt_dir=out_dir / "ref_ckpt_adafactor", ckpt_every=2,
               log_every=0, cbp_manage=False)
    params = build(configs.get_smoke(CKPT_ARCH)).init(
        jax.random.PRNGKey(0))
    out = {"first_losses": np.asarray(out1["losses"]),
           "continued_losses": np.asarray(out2["losses"])}
    out.update({f"params/{k}": v for k, v in flatten(params).items()})
    return out


def _run(path: str, jobs) -> None:
    import jax
    import jax.numpy as jnp

    assert not jax.config.jax_enable_x64
    from repro import configs

    arrays, done = {}, {}
    for job in jobs:
        kind, _, name = job.partition(":")
        if kind == "grads":
            # yi-9b, yi-34b and minitron-8b's smoke configs differ in
            # name alone: one reference
            key = (dataclasses.replace(case_config(configs, name), name=""),
                   PARAM_KEY[name])
            if key not in done:
                done[key] = _grads(jax, jnp, name)
            res = done[key]
        elif kind == "traj":
            res = _trajectory(jax, jnp, name)
        elif kind == "optim":
            res = _optim(jax, jnp)
        elif kind == "compress":
            res = _compress(jax, jnp)
        elif kind == "ckpt":
            res = _ckpt(jax, Path(path).parent)
        else:
            raise ValueError(job)
        arrays.update({f"{job}|{k}": _savable(v) for k, v in res.items()})
    np.savez(path, **arrays)


def _savable(value) -> np.ndarray:
    """bfloat16 as float32 (exact): ``np.savez`` has no bfloat16."""
    a = np.asarray(value)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2:])
