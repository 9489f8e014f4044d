"""The training mesh on the card: the reference's sharded-training gate
(``tests/test_distributed.py``: qwen3-8b, qwen3-moe-30b-a3b and
mamba2-1.3b smoke configs in f32, three AdamW steps at lr 1e-3 in 2
microbatches) on a (1, 1) ("data", "model") NCCL mesh of this process,
parameters and optimizer state placed by their specs, against the same
steps without a mesh on the card, TF32 off: losses finite and falling,
losses and parameters within the training bounds of
``tests/test_torch_mesh.py`` (a (1, 1) mesh runs the same local
products, so they are expected bit for bit).  With two cards or more, a
(1, 2) mesh of two processes, one a card (tensor-parallel over
"model"), against the one-card run within the same bounds.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mesh_cuda.py``.  The file imports neither JAX nor the
JAX package.
"""

import pytest
import torch

from test_torch_mesh import assert_same_training, run_on_mesh

from repro_torch import configs
from repro_torch import distributed as D
from repro_torch.launch import mesh_train as mt

pytestmark = pytest.mark.cuda


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
    D.start_ranks(str(store), 0, 1)
    try:
        yield D.make_mesh((1, 1), mt.AXES)
    finally:
        D.end_ranks()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def card_run(arch, shape, mesh=None):
    cfg = mt.gate_config(configs.get_smoke(arch), shape)
    return mt.train_on_mesh(cfg, mesh, mt.gate_batches(cfg, mt.GATE_STEPS),
                            device="cuda")


@pytest.mark.parametrize("arch", mt.GATE_ARCHS)
def test_gate_on_a_one_card_mesh_equals_no_mesh(nccl_mesh, arch):
    got = card_run(arch, (1, 1), nccl_mesh)
    losses = got["losses"]
    assert all(map(torch.isfinite, torch.tensor(losses))), losses
    assert losses[-1] < losses[0], losses
    assert_same_training(got, card_run(arch, (1, 1)), mt.GATE_STEPS, arch)


def test_a_mesh_of_two_cards_equals_one_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: a (1, 2) NCCL mesh runs one "
                    "process a card, and NCCL refuses two ranks on one")
    spec = {"mesh": [1, 2], "device": "cuda", "train": [
        {"name": a, "arch": a, "batch": "tokens", "steps": mt.GATE_STEPS}
        for a in mt.GATE_ARCHS]}
    got = run_on_mesh(tmp_path, spec, timeout=600)
    for arch in mt.GATE_ARCHS:
        assert_same_training(got[arch], card_run(arch, (1, 2)),
                             mt.GATE_STEPS, arch)
