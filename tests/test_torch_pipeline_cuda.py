"""The GPipe pipeline (``repro_torch.train.pipeline``) on the card, TF32
off: the CPU tests' gate cases (``tests/_torch_pipeline_ref.py``) at
S = 1 on a (1, 1) ("pod", "data") NCCL mesh of this process, one card
being one rank: outputs and gradients of ``sum(out ** 2)`` bit for bit
the port's sequential stack on the card, and within the reference gate's
1e-5 (outputs) and PR 25's gradient bound of the stack on the CPU.  With
two cards or more, two NCCL processes, one a card
(``tests/_torch_pipeline_run.py``): every two-device case (S = 2 on
(2, 1), the bubble cases, S = 1 on (1, 2)) and qwen3-8b's smoke layers
as two stages, against the CPU stack and ``transformer.forward`` within
the same bounds.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_pipeline_cuda.py``.  The file imports neither JAX nor
the JAX package.
"""
import os
import sys

import numpy as np
import pytest
import torch

import _torch_pipeline_ref as ref
import _torch_pipeline_run as run

from repro_torch import distributed as D

pytestmark = pytest.mark.cuda

OUT_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def grad_outside(got: np.ndarray, want: np.ndarray) -> int:
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max()))
    return int((np.abs(got - want) > atol + GRAD_RTOL * np.abs(want)).sum())


def assert_near_cpu(got: dict, name: str) -> None:
    cpu = run.stack_case(name, "cpu")
    assert float(np.abs(got["out"] - cpu["out"]).max()) < OUT_ATOL, name
    for leaf in ("dw", "dx"):
        assert grad_outside(got[leaf], cpu[leaf]) == 0, (name, leaf)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the mesh's NCCL group runs one "
                    "process a card")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = tmp_path_factory.mktemp("nccl") / "store"
    D.start_ranks(str(store), 0, 1, timeout=run.GROUP_TIMEOUT)
    try:
        yield D.make_mesh((1, 1), ref.AXES)
    finally:
        D.end_ranks()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.parametrize("case", list(ref.CASES))
def test_one_stage_on_the_card_equals_the_stack(nccl_mesh, case):
    got = run.gate_case(case, "cuda", mesh=nccl_mesh)
    for leaf in ("out", "dw", "dx"):
        assert np.array_equal(got[leaf], got["seq"][leaf]), (case, leaf)
    assert_near_cpu(got, case)


def test_two_cards_equal_the_cpu(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: NCCL refuses two ranks of one "
                    "group on one card")
    env = {**os.environ, "PYTHONPATH": str(ref.SRC), "TMPDIR": str(tmp_path)}
    proc = ref.launch([sys.executable, run.__file__, "2", str(tmp_path),
                       "cuda"], env, tmp_path / "log")
    ref.wait(proc, 600, tmp_path / "log")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for got in ranks:
        for name in got:
            if name == "model":
                continue
            assert_near_cpu(got[name], name)
        model = got["model"]
        assert abs(model["loss"] - model["loss_plain"]) <= 1e-5 * max(
            1.0, abs(model["loss_plain"]))
        for g, w in zip(model["grads"], model["grads_plain"]):
            assert grad_outside(g, w) == 0
