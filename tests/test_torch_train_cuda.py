"""The training stack on the card against the port's own CPU run.

* Every smoke config takes 3 AdamW steps from parameters built on the
  CPU and copied to the card (float32, TF32 off): losses within ``1e-5
  max(1, |loss|) + 1e-4 |loss|``, parameters within that bound on at
  least 99.9 % of entries and every entry within ``2 lr steps`` (AdamW's
  first step is nearly a sign function; MoE gradients sum by atomics on
  the card); zamba2-7b (ROADMAP R4) also within 4 of the CPU run's own
  one-ulp spreads.
* The optimizers on identical inputs equal the CPU within rtol 1e-6;
  ``compress_grads`` equals it bit for bit (its scale divides by a tensor
  on the card, never by a host scalar).
* bf16 parameters and the f32 optimizer state come back from a
  checkpoint on the card bit for bit; the loop's loss falls.
* ``tests/test_train_loop.py:34``'s plant on the card: the port's
  ``CBPCoordinator`` converges as the test asserts, and the greedy kernel
  launches once per reconfiguration.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_train_cuda.py``.  The file imports neither JAX nor the
JAX package.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from _torch_train_ref import (
    OPTIM_KINDS,
    OPTIM_LR,
    compress_seed_input,
    optim_inputs,
    training_plant_step_fn,
)

from repro_torch import configs
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core.coordinator import CBPCoordinator
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.types import CBPParams, fig8_schedule
from repro_torch.launch.train import train_loop
from repro_torch.models import Model, build
from repro_torch.models import layers as L
from repro_torch.optim import compress_grads, make_optimizer
from repro_torch.runtime.cbp_runtime import TrainingPlant
from repro_torch.train import TrainStepConfig, build_train_step

pytestmark = pytest.mark.cuda

ATOL, RTOL, SHARE, R4_FACTOR = 1e-5, 1e-4, 0.999, 4
STEPS, LR, B, S = 3, 1e-3, 2, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the training stack's card run "
                    "is held to its CPU run")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def batch(cfg, step: int, device) -> dict:
    g = torch.Generator().manual_seed(step)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    out = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn(B, S, cfg.d_model, generator=g)
    if cfg.frontend in ("audio", "patch") and cfg.family != "encdec":
        out = {"embeddings": torch.randn(B, S, cfg.d_model, generator=g),
               "labels": out["labels"]}
    return {k: v.to(device) for k, v in out.items()}


def trained(model, device):
    init_opt, step = build_train_step(model, TrainStepConfig(lr=LR))
    params = model.params
    opt = init_opt(params)
    losses = []
    for i in range(STEPS):
        params, opt, metrics = step(params, opt, batch(model.cfg, i, device))
        losses.append(float(metrics["loss"]))
    return (torch.tensor(losses, dtype=torch.float64),
            [p.detach().float().cpu() for p in L.tree_leaves(params)])


def nudged(model):
    return Model(model.cfg, L.tree_map(
        lambda t: torch.nextafter(t, torch.full_like(t, float("inf"))),
        copy.deepcopy(model.params)))


@pytest.mark.parametrize("name", configs.names())
def test_card_training_equals_cpu(card, name):
    cpu = build(configs.get_smoke(name), device="cpu", seed=0)
    on_card = copy.deepcopy(cpu).to(card)
    spreads = None
    if name == "zamba2-7b":
        spreads = trained(nudged(cpu), "cpu")
    want_l, want_p = trained(cpu, "cpu")
    got_l, got_p = trained(on_card, card)
    loss_spread = 0.0 if spreads is None else float(
        (spreads[0] - want_l).abs().max())
    atol = max(ATOL * max(1.0, float(want_l.abs().max())),
               R4_FACTOR * loss_spread)
    assert bool(got_l.isfinite().all())
    torch.testing.assert_close(got_l, want_l, rtol=RTOL, atol=atol)
    outside = total = 0
    for i, (g, w) in enumerate(zip(got_p, want_p)):
        diff = (g - w).abs()
        assert float(diff.max()) <= 2 * LR * STEPS, (name, i)
        spread = 0.0 if spreads is None else float(
            (spreads[1][i] - w).abs().max())
        leaf_atol = max(ATOL * max(1.0, float(w.abs().max())),
                        R4_FACTOR * spread)
        outside += int((diff > leaf_atol + RTOL * w.abs()).sum())
        total += w.numel()
    assert outside <= (1 - SHARE) * total, (name, outside, total)


@pytest.mark.parametrize("kind", OPTIM_KINDS)
def test_card_optimizer_equals_cpu(card, kind):
    params_np, grads_np = optim_inputs()
    dtype = torch.bfloat16 if kind == "adamw_bf16" else torch.float32
    out = {}
    for device in ("cpu", card):
        # copies: the updates write the parameters in place
        params = {k: torch.tensor(v, device=device).to(dtype)
                  for k, v in params_np.items()}
        init, update = make_optimizer(kind.removesuffix("_bf16"), OPTIM_LR)
        state = init(params)
        for g in grads_np:
            params, state = update(
                params, {k: torch.tensor(v, device=device).to(dtype)
                         for k, v in g.items()}, state)
        out[device] = ([t.float().cpu() for t in L.tree_leaves(params)],
                       int(state.step))
    assert out["cpu"][1] == out[card][1] == len(grads_np)
    for a, b in zip(out[card][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_card_compression_equals_cpu_bit_for_bit(card):
    for seed in range(64):
        g = torch.from_numpy(compress_seed_input(seed))
        want = compress_grads({"w": g})
        got = compress_grads({"w": g.to(card)})
        for a, b in zip(got, want):
            assert torch.equal(a["w"].cpu(), b["w"]), seed


def test_card_bf16_checkpoint_round_trip(card, tmp_path):
    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"),
                              param_dtype="bfloat16")
    model = build(cfg, card, seed=0)
    init_opt, step = build_train_step(model, TrainStepConfig())
    params = model.params
    opt = init_opt(params)
    for i in range(2):
        params, opt, _ = step(params, opt, batch(cfg, i, card))
    tree = {"params": params, "opt": opt}
    save_pytree(tree, tmp_path / "s")
    pairs = ckpt_mod._leaves(tree)
    like = ckpt_mod._rebuild(tree, {ckpt_mod._name(p): torch.zeros_like(t)
                                    for p, t in pairs})
    got, _ = load_pytree(tmp_path / "s", like)
    assert params["embed"].dtype == torch.bfloat16
    for (path, want), (_, g) in zip(pairs, ckpt_mod._leaves(got)):
        assert g.device == want.device and g.dtype == want.dtype
        assert torch.equal(g, want), ckpt_mod._name(path)


def test_card_train_loop_loss_decreases(card):
    out = train_loop("qwen3-8b", steps=30, batch=4, seq=32, log_every=0,
                     cbp_manage=False)
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_card_training_plant_binding(card):
    units, bw = 64, 100.0
    params = CBPParams(min_bandwidth_allocation=5.0, min_ways=2)
    plant = TrainingPlant(2, units, bw, training_plant_step_fn(units, bw),
                          device=card)
    coord = CBPCoordinator(plant, params=params)
    reset_launch_counts()
    coord.run(100.0)
    launches = launch_counts()["lookahead_greedy"]
    alloc = coord.alloc
    assert alloc.cache_units[0] > alloc.cache_units[1]
    assert alloc.bandwidth[1] > alloc.bandwidth[0]
    assert bool(alloc.prefetch_on[0])
    assert int(alloc.cache_units.sum()) == units
    assert np.isclose(float(alloc.bandwidth.sum()), bw)
    assert launches == sum(seg.kind == "reconfigure"
                           for seg in fig8_schedule(100.0, params, True))
