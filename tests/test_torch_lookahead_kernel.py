"""The port's Lookahead greedy against the JAX package and its oracles.

The greedy's plain PyTorch version (what a CPU tensor runs) must equal
the JAX Pallas kernel ``lookahead_greedy`` (interpret mode, float64, run
in a subprocess) and the kernel's numpy oracle ``ref.greedy_ref`` exactly,
on concave, nonmonotone and flat curves, plain and masked; the full
allocation (greedy + spread) must equal the numpy goldens
``lookahead_allocate`` / ``cppf_allocate``.  Random float curves make
exact marginal-utility ties measure-zero, so equality is exact.  The CUDA
kernel itself runs only on the card (``-m cuda``); the edge cases it is
held to there (``GREEDY_EDGE_CASES``) are held here to the Pallas kernel
and the oracle.
"""
import numpy as np
import pytest
import torch
from _torch_jax_ref import (
    GREEDY_EDGE_CASES,
    GREEDY_KINDS,
    GREEDY_SHAPES,
    greedy_curves,
    greedy_edge_inputs,
    jax_reference,
)

from repro.core import cache_controller as golden
from repro.kernels.lookahead_greedy.ref import greedy_ref
from repro_torch.core import cache_controller as cc
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.kernels.lookahead_greedy import (
    LAUNCHES,
    lookahead_greedy,
    lookahead_greedy_plain,
)

CASES = [(kind, masked, shape) for shape in GREEDY_SHAPES
         for kind in GREEDY_KINDS for masked in (False, True)]


def _key(kind, masked, shape):
    B, n, U = shape
    return f"{kind}_{int(masked)}_{B}x{n}x{U}"


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference("lookahead", tmp_path_factory)


def _inputs(ref, key):
    t = {f: torch.as_tensor(ref[f"{key}_{f}"])
         for f in ("curves", "mins", "active", "remaining")}
    return (t["curves"], t["mins"], t["active"].to(torch.int32),
            t["remaining"])


@pytest.mark.parametrize("kind,masked,shape", CASES)
def test_plain_greedy_equals_jax_pallas_kernel(jax_ref, kind, masked,
                                               shape):
    key = _key(kind, masked, shape)
    alloc, bal = lookahead_greedy_plain(*_inputs(jax_ref, key),
                                        total_units=shape[2])
    np.testing.assert_array_equal(alloc.numpy(), jax_ref[f"{key}_alloc"])
    np.testing.assert_array_equal(bal.numpy(), jax_ref[f"{key}_balance"])


@pytest.mark.parametrize("kind,masked,shape", CASES)
def test_plain_greedy_equals_numpy_oracle(jax_ref, kind, masked, shape):
    key = _key(kind, masked, shape)
    curves, mins, active, rem = _inputs(jax_ref, key)
    alloc, bal = lookahead_greedy_plain(curves, mins, active, rem,
                                        total_units=shape[2])
    for b in range(shape[0]):
        want_alloc, want_bal = greedy_ref(
            curves[b].numpy(), int(mins[b]), active[b].numpy() != 0,
            int(rem[b]), shape[2])
        np.testing.assert_array_equal(alloc[b].numpy(), want_alloc)
        assert int(bal[b]) == want_bal


@pytest.mark.parametrize("kind,masked,shape", CASES)
def test_allocation_equals_jax_and_numpy_golden(jax_ref, kind, masked,
                                               shape):
    key = _key(kind, masked, shape)
    B, n, U = shape
    curves = jax_ref[f"{key}_curves"]
    mins = jax_ref[f"{key}_mins"].astype(np.int64)
    active = jax_ref[f"{key}_active"]
    got = cc.lookahead_allocate_masked(curves, U, mins, active,
                                       device="cpu")
    np.testing.assert_array_equal(got, jax_ref[f"{key}_full"])
    for b in range(B):
        want = (golden.cppf_allocate(curves[b], U, int(mins[b]), active[b])
                if masked else
                golden.lookahead_allocate(curves[b], U, int(mins[b])))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("name", GREEDY_EDGE_CASES)
def test_plain_greedy_equals_jax_pallas_kernel_on_edge_cases(jax_ref, name):
    """The edge cases the card tests hold the CUDA kernel to: the plain
    version, its oracle there, equals the Pallas kernel on them."""
    curves, mins, active, rem, U = greedy_edge_inputs(name)
    alloc, bal = lookahead_greedy_plain(
        torch.as_tensor(curves), torch.as_tensor(mins),
        torch.as_tensor(active), torch.as_tensor(rem), total_units=U)
    np.testing.assert_array_equal(alloc.numpy(),
                                  jax_ref[f"edge_{name}_alloc"])
    np.testing.assert_array_equal(bal.numpy(),
                                  jax_ref[f"edge_{name}_balance"])


@pytest.mark.parametrize("name", GREEDY_EDGE_CASES)
def test_plain_greedy_equals_numpy_oracle_on_edge_cases(name):
    curves, mins, active, rem, U = greedy_edge_inputs(name)
    alloc, bal = lookahead_greedy_plain(
        torch.as_tensor(curves), torch.as_tensor(mins),
        torch.as_tensor(active), torch.as_tensor(rem), total_units=U)
    for b in range(curves.shape[0]):
        want_alloc, want_bal = greedy_ref(curves[b], int(mins[b]),
                                          active[b] != 0, int(rem[b]), U)
        np.testing.assert_array_equal(alloc[b].numpy(), want_alloc)
        assert int(bal[b]) == want_bal


def test_lookahead_allocate_plain_equals_golden():
    rng = np.random.default_rng(4)
    curves = greedy_curves(rng, 5, 8, 64, "concave")
    got = cc.lookahead_allocate(curves, 64, min_units=2, device="cpu")
    for b in range(5):
        np.testing.assert_array_equal(
            got[b], golden.lookahead_allocate(curves[b], 64, 2))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(5)
    curves = torch.as_tensor(greedy_curves(rng, 4, 6, 30, "nonmonotone"))
    args = (curves, torch.full((4,), 2, dtype=torch.int32),
            torch.ones((4, 6), dtype=torch.int32),
            torch.full((4,), 30, dtype=torch.int32))
    reset_launch_counts()
    got = lookahead_greedy(*args, total_units=30)
    want = lookahead_greedy_plain(*args, total_units=30)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert LAUNCHES.count == 0
    assert launch_counts()["lookahead_greedy"] == 0


@pytest.mark.parametrize("bad", ["dtype", "columns", "active_shape"])
def test_wrapper_rejects_malformed_inputs(bad):
    curves = torch.zeros((2, 3, 11), dtype=torch.float64)
    mins = torch.zeros(2, dtype=torch.int32)
    active = torch.ones((2, 3), dtype=torch.int32)
    rem = torch.full((2,), 10, dtype=torch.int32)
    total = 10
    if bad == "dtype":
        curves = curves.float()
    elif bad == "columns":
        total = 12
    else:
        active = torch.ones((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        lookahead_greedy(curves, mins, active, rem, total_units=total)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU "
                    "interpret mode (run with -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GREEDY_KINDS)
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_kernel_equals_plain_version(cuda_device, kind, masked):
    rng = np.random.default_rng(6)
    B, n, U = 96, 16, 256
    curves = torch.as_tensor(greedy_curves(rng, B, n, U, kind),
                             device=cuda_device)
    mins = torch.full((B,), 4, dtype=torch.int32, device=cuda_device)
    act = (rng.integers(0, 2, (B, n)) if masked else np.ones((B, n)))
    active = torch.as_tensor(act, dtype=torch.int32, device=cuda_device)
    rem = (U - mins * (n - active.sum(-1))).to(torch.int32)
    before = LAUNCHES.count
    alloc, bal = lookahead_greedy(curves, mins, active, rem, total_units=U)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    want = lookahead_greedy_plain(curves, mins, active, rem, total_units=U)
    assert torch.equal(alloc, want[0]) and torch.equal(bal, want[1])
