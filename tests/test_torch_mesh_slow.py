"""The reference's 8-device gate on the port, ``slow`` as the
reference's is (``tests/test_distributed.py``): 8 gloo processes on a
(2, 4) ("data", "model") mesh.

* qwen3-8b, qwen3-moe-30b-a3b and mamba2-1.3b, changed as the reference
  changes them, start from the JAX package's own initial parameters
  (``params_from_jax``) and train three AdamW steps on the reference's
  batch of zeros; their losses must equal the JAX package's (2, 4) run on
  8 forced host devices (``tests/_torch_mesh_ref.py``) within rtol 1e-4,
  and fall.
* mamba2-1.3b on the tier-1 (2, 2) mesh of 4 processes equals its
  one-process run within the training bounds (``tests/test_torch_mesh.py``
  runs the other two gate configs so).
* Every other smoke config trains one step under the (2, 4) mesh, its
  loss within rtol 1e-4 of its one-process loss, and qwen3-8b decodes
  three steps on a cache placed by ``cache_specs``, its logits within
  rtol 1e-4 / atol 1e-5 of the one-process decode: so every restored
  ``constrain`` site runs under a mesh.
"""
import numpy as np
import pytest

import _torch_mesh_ref as ref
from _torch_mesh_run import decode_run
from test_torch_mesh import (
    LOSS_ATOL,
    LOSS_RTOL,
    assert_same_training,
    one_process,
    run_on_mesh,
)

from repro_torch import configs
from repro_torch.launch import mesh_train as mt

pytestmark = pytest.mark.slow

WIDE = (2, 4)
OTHERS = [a for a in configs.names() if a not in mt.GATE_ARCHS]


@pytest.fixture(scope="module")
def jax_gate(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_gate")
    return out, ref.gate_reference(out)


@pytest.fixture(scope="module")
def wide_runs(tmp_path_factory, jax_gate):
    weights_dir, _ = jax_gate
    spec = {"mesh": list(WIDE),
            "train": [{"name": a, "arch": a, "batch": "zeros",
                       "steps": mt.GATE_STEPS,
                       "weights": str(weights_dir / f"{a}.pkl")}
                      for a in mt.GATE_ARCHS]
            + [{"name": a, "arch": a, "batch": "tokens", "steps": 1}
               for a in OTHERS],
            "decode": [{"name": "decode", "arch": "qwen3-8b"}]}
    return run_on_mesh(tmp_path_factory.mktemp("wide"), spec, timeout=1800)


@pytest.mark.parametrize("arch", mt.GATE_ARCHS)
def test_gate_losses_equal_the_jax_packages_on_8_devices(
        jax_gate, wide_runs, arch):
    _, want = jax_gate
    assert want["n_devices"] == 8
    got = np.asarray(wide_runs[arch]["losses"])
    assert np.allclose(got, want[arch], rtol=1e-4), (arch, got, want[arch])
    assert np.all(np.isfinite(got)) and got[-1] < got[0], got


@pytest.mark.parametrize("arch", OTHERS)
def test_every_family_trains_under_the_mesh(wide_runs, arch):
    got = wide_runs[arch]["losses"]
    want = one_process(arch, WIDE, steps=1)["losses"]
    assert np.allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL), (
        arch, got, want)


def test_decode_under_the_mesh_equals_one_process(wide_runs):
    cfg = mt.gate_config(configs.get_smoke("qwen3-8b"), WIDE)
    want = decode_run(cfg, None, "cpu")["logits"]
    for got, w in zip(wide_runs["decode"]["logits"], want):
        assert np.allclose(got, w, rtol=1e-4, atol=1e-5)


def test_mamba2_on_the_tier1_mesh_equals_one_process(tmp_path):
    spec = {"mesh": [2, 2], "train": [
        {"name": "mamba2-1.3b", "arch": "mamba2-1.3b", "batch": "tokens",
         "steps": mt.GATE_STEPS}]}
    got = run_on_mesh(tmp_path, spec, timeout=600)["mamba2-1.3b"]
    losses = got["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert_same_training(got, one_process("mamba2-1.3b", (2, 2)),
                         mt.GATE_STEPS, "mamba2-1.3b")
