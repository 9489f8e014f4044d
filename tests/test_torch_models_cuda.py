"""The model stack on the card against the port's own CPU run.

Every smoke config is built from a seed on the CPU and copied to the
card; loss, prefill and 12 decode steps on the card equal the CPU run
within ``chip_smoke.py`` phase 14(a)'s bound (rtol 1e-4, atol 1e-5, or 4
times the CPU run's own one-ulp spread where that passes 1e-5: zamba2-7b,
ROADMAP R4), with TF32 off.
MoE routing and the kept-slot table are exactly the CPU's, also at a
capacity where every expert overflows: the kept-slot rule (ROADMAP R3)
does not rest on the order of duplicate scatters, which CUDA leaves
undefined.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_models_cuda.py``.  The file imports neither JAX nor the
JAX package.
"""
import copy
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.models import Model, build, encdec, transformer
from repro_torch.models import layers as L

pytestmark = pytest.mark.cuda

RTOL, ATOL, R4_FACTOR = 1e-4, 1e-5, 4
B, S, T = 2, 32, 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the model stack's card run is "
                    "held to its CPU run")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def inputs(cfg, device):
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, S, cfg.d_model, generator=g)
    if cfg.frontend in ("audio", "patch") and cfg.family != "encdec":
        batch = {"embeddings": torch.randn(B, S, cfg.d_model, generator=g),
                 "labels": batch["labels"]}
    return {k: v.to(device) for k, v in batch.items()}


def run(model, batch, positions=None):
    """Loss, prefill and T decode steps (positions per step)."""
    cfg = model.cfg
    steps = batch["embeddings" if "embeddings" in batch else "tokens"]
    cache = model.init_cache(B, S, dtype=torch.float32)
    if cfg.family == "encdec":
        hidden = encdec.encode(model.params, cfg, batch["frames"])
        cache["xk"], cache["xv"] = encdec.cross_kv(model.params, cfg, hidden)
        cache["enc_len"] = torch.tensor(S, dtype=torch.int32,
                                        device=model.device)
    outs = []
    for i in range(T):
        pos = i if positions is None else positions[i]
        logits, cache = model.decode_step(cache, steps[:, i:i + 1], pos)
        outs.append(logits[:, 0])
    return {"loss": model.loss(batch), "prefill": model.prefill(batch),
            "decode": torch.stack(outs, 1)}


def nudged(model):
    return Model(model.cfg, L.tree_map(
        lambda t: torch.nextafter(t, torch.full_like(t, float("inf"))),
        model.params))


@pytest.mark.parametrize("name", configs.names())
def test_card_equals_cpu(card, name):
    cfg = configs.get_smoke(name)
    cpu = build(cfg, device="cpu", seed=0)
    on_card = copy.deepcopy(cpu).to(card)
    positions = ([[i, i + 2] for i in range(T)] if name == "qwen3-8b"
                 else None)
    want = run(cpu, inputs(cfg, "cpu"), positions)
    up = run(nudged(cpu), inputs(cfg, "cpu"), positions)
    got = run(on_card, inputs(cfg, card), positions)
    for key, w in want.items():
        spread = float((up[key] - w).abs().max())
        atol = ATOL if spread <= ATOL else R4_FACTOR * spread
        err = float((got[key].cpu() - w).abs().max())
        torch.testing.assert_close(
            got[key].cpu(), w, rtol=RTOL, atol=atol,
            msg=f"{key}: max |card - cpu| {err:.3g}, spread {spread:.3g}")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_card_moe_routing_and_kept_slots_equal_cpu(card, name,
                                                   capacity_factor):
    """At factor 0.5 every expert receives more than its capacity and
    keeps positions < C - 1 only (R3), on the card as on the CPU."""
    cfg = dataclasses.replace(configs.get_smoke(name),
                              capacity_factor=capacity_factor)
    params = build(cfg, device="cpu", seed=1).params
    lp = L.layer(params["layers"]["moe"], 0)
    x = torch.randn(1, B * S, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want = transformer.moe_route(lp, cfg, x)
    got = transformer.moe_route({k: v.to(card) for k, v in lp.items()}, cfg,
                                x.to(card))
    assert torch.equal(got.experts.cpu(), want.experts)
    assert torch.equal(got.slots.cpu(), want.slots)
    torch.testing.assert_close(got.gates.cpu(), want.gates, rtol=RTOL,
                               atol=ATOL)
    cap = want.slots.shape[-1]
    counts = torch.bincount(want.experts.reshape(-1),
                            minlength=cfg.n_experts)
    kept = (want.slots[0] < B * S * cfg.top_k).sum(-1)
    assert torch.equal(kept, torch.where(counts > cap, cap - 1,
                                         counts.clamp(max=cap)))
    if capacity_factor == 0.5:
        assert bool((counts > cap).all()), counts
    y_cpu = transformer.moe_ffn(lp, cfg, x)
    y_card = transformer.moe_ffn({k: v.to(card) for k, v in lp.items()},
                                 cfg, x.to(card))
    # the combine's scatter-add sums in another order on the card
    torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=RTOL, atol=ATOL)


def test_card_build_draws_on_the_card(card):
    cfg = configs.get_smoke("qwen3-8b")
    a, b = build(cfg, seed=4), build(cfg, seed=4)
    assert a.device.type == "cuda"
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert bool(torch.isfinite(a.loss(inputs(cfg, card))))
