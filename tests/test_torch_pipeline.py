"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
JAX package's (``repro.train.pipeline.pipeline_apply``) and against the
port's own sequential stack, on gloo processes.

The cases (``tests/_torch_pipeline_ref.py``): the reference gate
(``tests/test_pipeline.py``: D = 16, L = 4, S = 2, four microbatches of
(8, 16), f32, on a (2, 2) ("pod", "data") mesh), S = 2 on (2, 1), S = 4 on
(4, 1) with L = 8, the bubble cases (``n_micro`` 1 and 3 at S = 2, 2 at
S = 4), and S = 1 on (1, 2) and on a one-rank (1, 1) mesh.  Ranks are
spawned by ``launch/mesh_train.py::spawn`` in two subprocesses (4 and 2
ranks, ``tests/_torch_pipeline_run.py``), each wait of a group bounded by
60 s and each subprocess by :data:`RUN_TIMEOUT`, so a hang fails fast;
the (1, 1) cases run in this process.  The JAX reference runs beside
them in a subprocess of its own (4 forced host devices, x64 off).

Bounds: outputs within the reference gate's 1e-5; every gradient entry
(stacked weights and stream) within PR 25's training bound
``1e-5 max(1, max|g|) + 1e-4 |g|``; the gradient's norm over the
sequential stack's is 1 (the reference measures 1.0000002), not S (a
broadcast whose backward sums every stage's cotangent) nor 2 (a sum over
the "data" replicas); S = 1 is bit for bit the stack.  qwen3-8b's smoke
config (f32, full remat) with its two layers as two stages, and as one,
against ``transformer.forward`` on the same microbatches: loss and every
parameter's gradient within the same bounds, (1, 1) bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

import _torch_pipeline_ref as ref
import _torch_pipeline_run as run

from repro_torch import distributed as D

RUN_TIMEOUT = 240
REF_TIMEOUT = 300
OUT_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ONE_RANK = [n for n, c in ref.CASES.items() if c["mesh"] == (1, 1)]
MULTI = [n for n in ref.CASES if n not in ONE_RANK]


def grad_outside(got: np.ndarray, want: np.ndarray) -> int:
    """Entries of ``got`` past PR 25's bound around ``want``."""
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max()))
    return int((np.abs(got - want) > atol + GRAD_RTOL * np.abs(want)).sum())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": JAX arrays by case, "ranks": {case: [rank results]}}``:
    the two rank subprocesses and the reference started together, the
    one-rank cases run here meanwhile."""
    tmp = tmp_path_factory.mktemp("pipeline")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ref.SRC), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp)}
    jax_out = tmp / "ref.npz"
    jax_proc = ref.start(jax_out)
    procs = {}
    for world in (4, 2):
        out = tmp / f"world{world}"
        out.mkdir()
        procs[world] = (ref.launch(
            [sys.executable, run.__file__, str(world), str(out)], env,
            out / "log"), out)
    ranks = {}
    try:
        D.start_ranks(tmp / "store", 0, 1, "cpu", run.GROUP_TIMEOUT)
        for name in ONE_RANK:
            ranks[name] = [run.gate_case(name, "cpu")]
        ranks["model_1x1"] = [run.model_case((1, 1), "cpu")]
    finally:
        D.end_ranks()
        for world, (proc, out) in procs.items():
            ref.wait(proc, RUN_TIMEOUT, out / "log")
    for world, (_, out) in procs.items():
        got = [torch.load(out / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
        for name in got[0]:
            ranks["model_2x1" if name == "model" else name] = [
                g[name] for g in got]
    return {"ref": ref.finish(jax_proc, jax_out, REF_TIMEOUT),
            "ranks": ranks}


@pytest.mark.parametrize("case", list(ref.CASES))
def test_outputs_match_reference(runs, case):
    want = runs["ref"][case]["out"]
    for r, got in enumerate(runs["ranks"][case]):
        err = float(np.abs(got["out"] - want).max())
        assert err < OUT_ATOL, (case, r, err)


@pytest.mark.parametrize("case", list(ref.CASES))
@pytest.mark.parametrize("leaf", ["dw", "dx"])
def test_gradients_match_reference(runs, case, leaf):
    want = runs["ref"][case][leaf]
    for r, got in enumerate(runs["ranks"][case]):
        assert got[leaf].shape == want.shape
        assert grad_outside(got[leaf], want) == 0, (
            case, leaf, r, float(np.abs(got[leaf] - want).max()))


@pytest.mark.parametrize("case", list(ref.CASES))
def test_gradient_is_not_stages_or_replicas_times_the_sequential(runs, case):
    """The trap of a broadcast whose backward sums every stage's copy of
    the cotangent (S times) or of a sum over "data" (2 times)."""
    seq = runs["ranks"][case][0]["seq"]["dw"]
    jax_dw = runs["ref"][case]["dw"]
    for got in runs["ranks"][case]:
        ratio = np.linalg.norm(got["dw"]) / np.linalg.norm(seq)
        assert abs(ratio - 1.0) < 1e-5, (case, ratio)
        ratio_ref = np.linalg.norm(got["dw"]) / np.linalg.norm(jax_dw)
        assert abs(ratio_ref - 1.0) < 1e-5, (case, ratio_ref)
        ratio_x = np.linalg.norm(got["dx"]) / np.linalg.norm(
            got["seq"]["dx"])
        assert abs(ratio_x - 1.0) < 1e-5, (case, ratio_x)


@pytest.mark.parametrize("case", list(ref.CASES))
def test_equals_the_ports_sequential_stack(runs, case):
    for got in runs["ranks"][case]:
        seq = got["seq"]
        assert float(np.abs(got["out"] - seq["out"]).max()) < OUT_ATOL
        for leaf in ("dw", "dx"):
            assert grad_outside(got[leaf], seq[leaf]) == 0, (case, leaf)


@pytest.mark.parametrize("case", MULTI)
def test_every_rank_holds_the_same_results(runs, case):
    first, *rest = runs["ranks"][case]
    assert len(rest) + 1 == np.prod(ref.CASES[case]["mesh"])
    for got in rest:
        for leaf in ("out", "dw", "dx"):
            assert np.array_equal(got[leaf], first[leaf]), (case, leaf)


@pytest.mark.parametrize("case", list(ref.CASES))
def test_gradients_keep_the_stage_placements(runs, case):
    stages = ref.CASES[case]["mesh"][0]
    pod = "S(0)" if stages > 1 else "R"
    for got in runs["ranks"][case]:
        assert got["placements"] == [pod, "R"], got["placements"]
        assert got["grad_placements"] == got["placements"]


@pytest.mark.parametrize("case", ["s1_1x1", "s1_1x2"])
def test_one_stage_is_bit_for_bit_the_stack(runs, case):
    for got in runs["ranks"][case]:
        for leaf in ("out", "dw", "dx"):
            assert np.array_equal(got[leaf], got["seq"][leaf]), (case, leaf)


@pytest.mark.parametrize("mesh", ["model_1x1", "model_2x1"])
def test_model_stages_equal_forward(runs, mesh):
    """qwen3-8b's smoke layers on the pipeline against
    ``transformer.forward`` on the same microbatches; one stage bit for
    bit."""
    for got in runs["ranks"][mesh]:
        loss, plain = got["loss"], got["loss_plain"]
        assert abs(loss - plain) <= 1e-5 * max(1.0, abs(plain)), (loss, plain)
        assert len(got["grads"]) == len(got["grads_plain"])
        for i, (g, w) in enumerate(zip(got["grads"], got["grads_plain"])):
            assert g.shape == w.shape
            assert grad_outside(g, w) == 0, (mesh, i)
        if mesh == "model_1x1":
            assert loss == plain
            assert all(np.array_equal(g, w) for g, w in
                       zip(got["grads"], got["grads_plain"]))


@pytest.fixture
def one_rank(tmp_path):
    D.start_ranks(tmp_path / "store", 0, 1, "cpu", run.GROUP_TIMEOUT)
    try:
        yield D.make_mesh((1, 1), ref.AXES, "cpu")
    finally:
        D.end_ranks()


def test_without_gradients_no_graph_is_kept(one_rank):
    from repro_torch.train.pipeline import pipeline_apply, place_stages

    ws_np, x_np = ref.inputs("s1_1x1")
    ws = torch.from_numpy(ws_np).requires_grad_()
    x = torch.from_numpy(x_np)
    stages = place_stages(ws, one_rank)
    with torch.no_grad():
        out = pipeline_apply(run.gate_stage, stages, x, one_rank)
    assert out.grad_fn is None
    seq = torch.stack([run.gate_stage(ws.detach(), xm) for xm in x])
    assert torch.equal(out, seq)


def test_refuses_a_missing_axis_bad_stages_and_a_reshaping_stage(one_rank):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.train.pipeline import pipeline_apply, place_stages

    ws_np, x_np = ref.inputs("s1_1x1")
    ws, x = torch.from_numpy(ws_np), torch.from_numpy(x_np)
    stages = place_stages(ws, one_rank)
    with pytest.raises(ValueError, match="no 'stage'"):
        pipeline_apply(run.gate_stage, stages, x, one_rank, axis="stage")
    with pytest.raises(ValueError, match="no 'stage'"):
        place_stages(ws, one_rank, axis="stage")
    with pytest.raises(ValueError, match="stage_fn returned"):
        pipeline_apply(lambda w, xb: xb[:, :4], stages, x, one_rank)
    with pytest.raises(ValueError, match="must be DTensors"):
        pipeline_apply(run.gate_stage, ws.reshape(1, *ws.shape), x, one_rank)
    two = DTensor.from_local(ws.reshape(2, 2, *ws.shape[1:]), one_rank,
                             [Replicate(), Replicate()])
    with pytest.raises(ValueError, match="leading size 2 on 1 stages"):
        pipeline_apply(run.gate_stage, two, x, one_rank)
