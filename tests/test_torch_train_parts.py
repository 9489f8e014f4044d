"""The training stack's parts in the port, on the CPU: the data pipeline's
copy, the optimizers and gradient compression on identical inputs against
the JAX package, ``tests/test_substrate.py``'s data, optimizer and
checkpoint tests and ``tests/test_train_loop.py``'s three gates on the
port's copies, and the port's own contracts: remat and the layers'
``unbind`` change memory, not values; microbatches equal one batch.

The optimizer and compression references come from one x64-off
subprocess (``tests/_torch_train_ref.py``, jobs ``optim`` and
``compress``): ``adamw_update`` (f32 and bf16 parameters),
``adafactor_update`` and ``"sgd"`` after 1 and 3 updates on the same
numpy parameters and gradients, held within rtol 1e-6 and atol 1e-7 with
``step`` exact; ``compress_grads`` bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from _torch_model_ref import case_config, model_inputs
from _torch_train_ref import (
    COMPRESS_ROUNDS,
    COMPRESS_SEEDS,
    OPTIM_KINDS,
    OPTIM_LR,
    OPTIM_UPDATES,
    PARTS_GROUPS,
    compress_ef_input,
    compress_seed_input,
    optim_inputs,
    train_reference,
    training_plant_step_fn,
)

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.coordinator import CBPCoordinator
from repro_torch.core.types import CBPParams
from repro_torch.data import PrefetchPipeline, SyntheticTokens
from repro_torch.launch.train import train_loop
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.optim import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    compress_grads,
    decompress_grads,
    make_optimizer,
)
from repro_torch.runtime.cbp_runtime import TrainingPlant
from repro_torch.train import TrainStepConfig, build_train_step
from repro_torch.train.step import _split

#: Optimizers on identical inputs.
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
#: Microbatches against one batch.
MICRO_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread runs their small ops
    fastest, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return train_reference(tmp_path_factory, PARTS_GROUPS)


def tensors(tree: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def as_numpy(t) -> np.ndarray:
    """A copy: the optimizers update their tensors in place."""
    return t.detach().float().numpy().copy()


# ------------------------------ data ------------------------------- #


def test_synthetic_tokens_equal_the_reference():
    """The copy's batches equal the reference's for many (seed, index)."""
    ref_data = pytest.importorskip("repro.data.pipeline")
    for seed in (0, 1, 3, 17, 2 ** 31 - 1):
        for start in (0, 1, 5, 1000):
            mine = SyntheticTokens(3, 7, 151936, seed=seed, start_index=start)
            theirs = ref_data.SyntheticTokens(3, 7, 151936, seed=seed,
                                              start_index=start)
            for _ in range(3):
                a, b = next(mine), next(theirs)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            assert mine.state() == theirs.state()


def test_synthetic_tokens_deterministic_and_resumable():
    """``test_substrate.py:28`` on the port's copy."""
    a = SyntheticTokens(2, 8, 100, seed=3)
    b1 = next(a)
    b2 = next(a)
    a2 = SyntheticTokens(2, 8, 100, seed=3, start_index=1)
    np.testing.assert_array_equal(next(a2)["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (2, 8)
    a2.restore(a.state())
    assert a2.state() == {"index": 2, "seed": 3}


def test_prefetch_pipeline_depth_and_metrics():
    """``test_substrate.py:37`` on the port's copy."""
    src = SyntheticTokens(1, 4, 10)
    pipe = PrefetchPipeline(src, depth=2, fetch_cost_s=0.005)
    batches = [next(pipe) for _ in range(5)]
    assert len(batches) == 5
    assert pipe.mean_wait_ms() >= 0.0
    assert pipe.throughput() > 0.0
    pipe.set_depth(0)          # throttle off
    assert pipe.depth == 0
    b = next(pipe)
    assert b["tokens"].shape == (1, 4)
    pipe.stop()


# ------------------- optimizers on identical inputs ----------------- #


def run_optimizer(kind: str):
    """The port's updates on :func:`optim_inputs`: {n: (params, state)}
    after each of :data:`OPTIM_UPDATES`, as numpy."""
    params_np, grads_np = optim_inputs()
    dtype = torch.bfloat16 if kind == "adamw_bf16" else torch.float32
    params = tensors(params_np, dtype)
    if kind.startswith("adamw"):
        init, upd = adamw_init, lambda p, g, s: adamw_update(
            p, g, s, lr=OPTIM_LR)
    elif kind == "adafactor":
        init, upd = adafactor_init, lambda p, g, s: adafactor_update(
            p, g, s, lr=OPTIM_LR)
    else:
        init, upd = make_optimizer("sgd", OPTIM_LR)
    state = init(params)
    out = {}
    for n in range(1, max(OPTIM_UPDATES) + 1):
        params, state = upd(params, tensors(grads_np[n - 1], dtype), state)
        if n in OPTIM_UPDATES:
            flat = {f"params/{k}": as_numpy(v) for k, v in params.items()}
            flat["opt/step"] = state.step.numpy().copy()
            for field in ("master", "m", "v"):
                tree = getattr(state, field)
                for k, v in (tree or {}).items():
                    if isinstance(v, tuple):
                        flat.update({f"opt/{field}/{k}/#{i}": as_numpy(t)
                                     for i, t in enumerate(v)})
                    else:
                        flat[f"opt/{field}/{k}"] = as_numpy(v)
            out[n] = flat
    return out


@pytest.mark.parametrize("kind", OPTIM_KINDS)
def test_optimizer_matches_reference_on_identical_inputs(
        kind, ref, record_property):
    got = run_optimizer(kind)
    worst = 0.0
    for n in OPTIM_UPDATES:
        prefix = f"{kind}/{n}/"
        want = {k[len(prefix):]: v for k, v in ref["optim"].items()
                if k.startswith(prefix)}
        assert sorted(got[n]) == sorted(want), (sorted(got[n]), sorted(want))
        for name, w in want.items():
            g = got[n][name]
            assert g.shape == w.shape, name
            if name == "opt/step":
                assert int(g) == int(w) == n
                continue
            np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"{kind} update {n} {name}")
            worst = max(worst, float(np.max(
                np.abs(g - w) / (OPT_ATOL + OPT_RTOL * np.abs(w)))))
    record_property("worst_share_of_bound", worst)


def test_adafactor_factors_as_the_reference(ref):
    """Matrices (and the last two axes of a stack) get row and column
    moments, the column leaf (``shape[-1] == 1``) and vectors one."""
    state = adafactor_init(tensors(optim_inputs()[0]))
    assert state.m is None
    shapes = {k: [tuple(t.shape) for t in v] for k, v in state.v.items()}
    assert shapes == {"w": [(8,), (4,)], "b": [(4,)], "s": [(2, 3), (2, 5)],
                      "c": [(6, 1)]}
    for k, v in shapes.items():
        for i, shape in enumerate(v):
            assert ref["optim"][f"adafactor/1/opt/v/{k}/#{i}"].shape == shape


def test_adamw_master_is_a_copy():
    """An f32 parameter never aliases its master (the reference's
    ``copy=True``); the update writes the parameters in place."""
    p = {"w": torch.ones(3)}
    state = adamw_init(p)
    assert state.master["w"].data_ptr() != p["w"].data_ptr()
    out, _ = adamw_update(p, {"w": torch.ones(3)}, state, lr=0.1)
    assert out["w"] is p["w"] and not torch.equal(p["w"], torch.ones(3))


def _tiny_params(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "b": torch.randn(4, generator=g)}


def _grad(loss_fn, params: dict) -> dict:
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(p), list(p.values()))
    return dict(zip(p, grads))


def test_adamw_reduces_quadratic_loss():
    """``test_substrate.py:61`` on the port."""
    params = _tiny_params(0)
    state = adamw_init(params)

    def loss(p):
        return sum(torch.sum(torch.square(a)) for a in L.tree_leaves(p))

    l0 = float(loss(params))
    for _ in range(50):
        params, state = adamw_update(params, _grad(loss, params), state,
                                     lr=0.05)
    assert float(loss(params)) < 0.2 * l0


def test_adafactor_reduces_quadratic_loss():
    """``test_substrate.py:77`` on the port."""
    params = _tiny_params(1)
    state = adafactor_init(params)

    def loss(p):
        return sum(torch.sum(torch.square(a)) for a in L.tree_leaves(p))

    l0 = float(loss(params))
    for _ in range(60):
        params, state = adafactor_update(params, _grad(loss, params), state,
                                         lr=0.05)
    assert float(loss(params)) < 0.5 * l0
    # factored second moment for the matrix leaf
    assert sum(len(v) for v in state.v.values()) > len(params)


# ------------------------ gradient compression ---------------------- #


def test_compression_error_feedback_equals_reference(ref):
    """50 rounds of ``test_substrate.py:92``'s case: q, scales, the
    error feedback and the dequantized gradient bit for bit."""
    g = {"w": torch.from_numpy(compress_ef_input())}
    err = None
    acc_q = np.zeros((64, 64), np.float32)
    for i in range(COMPRESS_ROUNDS):
        q, scales, err = compress_grads(g, err)
        deq = decompress_grads(q, scales)
        for name, got in (("q", q["w"]), ("scales", scales["w"]),
                          ("err", err["w"]), ("deq", deq["w"])):
            want = ref["compress"][f"ef/{name}"][i]
            assert got.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"round {i} {name}")
        acc_q += deq["w"].numpy()
    # error feedback keeps the long-run average unbiased
    np.testing.assert_allclose(acc_q / COMPRESS_ROUNDS,
                               compress_ef_input(), atol=2e-3)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, COMPRESS_SEEDS - 1))
def test_compression_equals_reference_over_seeds(ref, seed):
    """``test_substrate.py:109``'s case for any seed: bit for bit, and the
    dequantization error within half a step."""
    g = {"w": torch.from_numpy(compress_seed_input(seed))}
    q, scales, err = compress_grads(g)
    for name, got in (("q", q["w"]), ("scales", scales["w"]),
                      ("err", err["w"])):
        np.testing.assert_array_equal(
            got.numpy(), ref["compress"][f"seeds/{name}"][seed],
            err_msg=f"seed {seed} {name}")
    deq = decompress_grads(q, scales)
    scale = float(scales["w"])
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6


# --------------------------- checkpoints ---------------------------- #


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    """``test_substrate.py:121`` on the port, with tensors."""
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"data": {"index": step}})
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    step, restored, extra = mgr.restore_latest(tree)
    assert step == 3
    assert extra["data"]["index"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16


# ------------------------- remat and layers ------------------------- #

REMAT_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-7b",
               "whisper-tiny")


def loss_and_grads(cfg, batch, seed: int = 0):
    model = build(cfg, "cpu", seed=seed)
    model.requires_grad_(True)
    flat = L.tree_leaves(model.params)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss, grads


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_memory_not_values(arch):
    """Loss and every gradient bit-identical under remat none, full and
    dots, with each layer's attention chunks rematerialized inside."""
    base = case_config(configs, arch)
    batch = model_inputs(base)["batch"]
    runs = {mode: loss_and_grads(dataclasses.replace(base, remat=mode),
                                 batch)
            for mode in ("none", "full", "dots")}
    loss0, grads0 = runs["none"]
    for mode in ("full", "dots"):
        loss, grads = runs[mode]
        assert torch.equal(loss, loss0), mode
        for g, g0 in zip(grads, grads0):
            assert torch.equal(g, g0), mode


def test_remat_off_without_gradients():
    """Serving paths (frozen parameters, or gradients off) run the plain
    call: no checkpoint is set up."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"), remat="full")
    model = build(cfg, "cpu")
    batch = model_inputs(cfg)["batch"]
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    import repro_torch.models.attention as A
    import repro_torch.models.transformer as T
    T.checkpoint, A.checkpoint = spy, spy
    try:
        model.loss(batch)
        assert not calls
        model.requires_grad_(True)
        with torch.no_grad():
            model.loss(batch)
        assert not calls
        model.loss(batch)
        assert calls
    finally:
        T.checkpoint, A.checkpoint = orig, orig


def test_layers_unbind_equals_per_layer_select():
    """``L.layers`` (one ``unbind``) gives ``L.layer``'s views, and the
    gradients through it equal those through per-layer selects."""
    g = torch.Generator().manual_seed(0)
    stack = {"w": torch.randn(3, 4, 4, generator=g, requires_grad=True),
             "n": {"s": torch.randn(3, 4, generator=g, requires_grad=True)}}
    x = torch.randn(2, 4, generator=g)

    def run(pick):
        h = x
        for i, lp in enumerate(pick()):
            h = torch.tanh(h @ lp["w"] * lp["n"]["s"])
        return torch.autograd.grad(h.square().sum(),
                                   [stack["w"], stack["n"]["s"]])

    for i, lp in enumerate(L.layers(stack, 3)):
        assert torch.equal(lp["w"], L.layer(stack, i)["w"])
    a = run(lambda: L.layers(stack, 3))
    b = run(lambda: [L.layer(stack, i) for i in range(3)])
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# --------------------------- microbatches --------------------------- #


def test_microbatches_equal_one_batch():
    """``microbatches=2`` (f32 accumulation, ``1/k``) equals one batch of
    4 within rtol 1e-5, parameters and loss."""
    cfg = case_config(configs, "qwen3-8b")
    batch = next(SyntheticTokens(4, 32, cfg.vocab_size, seed=5))
    out = {}
    for k in (1, 2):
        model = build(cfg, "cpu", seed=0)
        init, step = build_train_step(
            model, TrainStepConfig(optimizer="sgd", lr=0.1, microbatches=k))
        params = model.params
        params, _, metrics = step(params, init(params), batch)
        out[k] = (float(metrics["loss"]),
                  [p.detach().clone() for p in L.tree_leaves(params)])
    assert out[1][0] == pytest.approx(out[2][0], rel=MICRO_RTOL)
    for a, b in zip(out[1][1], out[2][1]):
        torch.testing.assert_close(b, a, rtol=MICRO_RTOL, atol=1e-7)


def test_microbatch_split_keeps_scalars_and_refuses_ragged():
    batch = {"tokens": torch.arange(12).reshape(6, 2),
             "cur": torch.tensor(3)}
    parts = _split(batch, 3)
    assert [p["tokens"].shape[0] for p in parts] == [2, 2, 2]
    assert all(p["cur"] is batch["cur"] for p in parts)
    with pytest.raises(ValueError, match="microbatches"):
        _split(batch, 4)


# ------------------ tests/test_train_loop.py on the port ------------ #


def test_train_loss_decreases():
    """``test_train_loop.py:13`` on the port."""
    out = train_loop("qwen3-8b", steps=30, batch=4, seq=32,
                     log_every=0, cbp_manage=False, device="cpu")
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first, (first, last)


def test_train_restart_from_checkpoint(tmp_path):
    """``test_train_loop.py:21`` on the port."""
    ckpt = tmp_path / "ckpt"
    kw = dict(batch=2, seq=32, ckpt_dir=ckpt, ckpt_every=5, log_every=0,
              cbp_manage=False, device="cpu")
    train_loop("mamba2-1.3b", steps=10, **kw)
    # "crash" and restart: resumes from step 10 and continues to 16
    out2 = train_loop("mamba2-1.3b", steps=16, **kw)
    assert len(out2["losses"]) == 6  # only steps 10..15 re-run
    assert np.isfinite(out2["final_loss"])


def test_training_plant_coordinator_integration():
    """``test_train_loop.py:34`` on the port's ``CBPCoordinator`` and
    ``TrainingPlant``, its assertions unchanged."""
    total_units, total_bw = 64, 100.0
    plant = TrainingPlant(2, total_units, total_bw,
                          training_plant_step_fn(total_units, total_bw),
                          device="cpu")
    coord = CBPCoordinator(
        plant, params=CBPParams(min_bandwidth_allocation=5.0, min_ways=2))
    coord.run(100.0)
    alloc = coord.alloc
    assert alloc.cache_units[0] > alloc.cache_units[1]
    assert alloc.bandwidth[1] > alloc.bandwidth[0]
    assert bool(alloc.prefetch_on[0])
    assert int(alloc.cache_units.sum()) == total_units
    assert np.isclose(alloc.bandwidth.sum(), total_bw)
