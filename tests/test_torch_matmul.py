"""The port's CBP blocked matmul against the JAX package.

The plain version (what a CPU tensor runs) is held to the JAX Pallas
kernel ``cbp_matmul`` in interpret mode and to its oracle ``matmul_ref``,
on inputs made from a seed with numpy, at the tolerances of
``tests/test_kernels.py`` (f32 1e-4 as its pad-aware matmul test, bf16
2e-2: one bf16 rounding of the f32 sum).  Knob sets include dims that no
knob divides (the planner's pad-aware blocks) and m < 8.  The CUDA kernel
itself runs only on the card: ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip(
    "jax.numpy",
    reason="compares with the JAX reference package, not installed here")

from repro.kernels.cbp_matmul.kernel import cbp_matmul as pallas_matmul
from repro.kernels.cbp_matmul.kernel import vmem_footprint_bytes
from repro.kernels.cbp_matmul.ref import matmul_ref
from repro_torch.kernels.cbp_matmul import (
    LAUNCHES,
    cbp_matmul,
    cbp_matmul_plain,
    smem_footprint_bytes,
)
from repro_torch.kernels.cbp_matmul.ops import _launch_args

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (m, k, n, block_m, block_n, block_k)
CASES = [
    (256, 128, 256, 64, 64, 64),
    (256, 128, 256, 128, 64, 32),
    (256, 128, 256, 32, 128, 64),
    (97, 53, 70, 104, 72, 56),      # no knob divides a dim
    (4, 128, 128, 4, 128, 128),     # m < 8: one whole-extent tile
    (130, 96, 70, 32, 24, 40),
]


def _operands(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    return ((torch.tensor(a).to(tdt), torch.tensor(b).to(tdt)),
            (jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax_pallas_kernel(case, dtype):
    m, k, n, bm, bn, bk = case
    (a, b), (ja, jb) = _operands(m, k, n, dtype)
    got = cbp_matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
    want = pallas_matmul(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                         interpret=True)
    assert got.dtype == a.dtype and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 128, 256), (97, 53, 70)])
def test_plain_equals_oracle(shape, dtype):
    (a, b), (ja, jb) = _operands(*shape, dtype, seed=1)
    np.testing.assert_allclose(_np(cbp_matmul_plain(a, b)),
                               _np(matmul_ref(ja, jb)), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    (a, b), _ = _operands(64, 32, 48, "float32")
    before = LAUNCHES.count
    torch.testing.assert_close(cbp_matmul(a, b, block_m=8, block_n=16,
                                          block_k=8),
                               cbp_matmul_plain(a, b), rtol=0, atol=0)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("bad", ["inner", "dtype", "knob", "ndim"])
def test_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.zeros(8, 4), torch.zeros(4, 8)
    args = {"inner": (a, torch.zeros(5, 8)),
            "dtype": (a, b.double()),
            "knob": (a, b),
            "ndim": (a[None], b)}[bad]
    kw = {"block_k": 0} if bad == "knob" else {}
    with pytest.raises(ValueError):
        cbp_matmul(*args, **kw)


@pytest.mark.parametrize("knobs,dtype_bytes,want", [
    ((128, 128, 128), 2, 32 * (65 + 64) * 2),
    ((256, 256, 256), 4, 32 * (65 + 64) * 4),
    ((104, 72, 56), 4, 32 * (65 + 64) * 4),
    ((4, 128, 16), 4, 16 * (5 + 64) * 4),
    ((8, 16, 8), 2, 8 * (9 + 16) * 2),
])
def test_smem_footprint_is_what_the_launch_requests(knobs, dtype_bytes,
                                                    want):
    assert smem_footprint_bytes(*knobs, dtype_bytes) == want
    dtype = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    a, b = torch.zeros(16, 8, dtype=dtype), torch.zeros(8, 16, dtype=dtype)
    out = torch.empty(16, 16, dtype=dtype)
    args = _launch_args(a, b, out, *knobs)
    assert args[-1] == want and args[-2] == (dtype_bytes == 2)
    # Unlike the reference's VMEM footprint, it is bounded by the staging
    # pieces, not by the knobs.
    assert smem_footprint_bytes(4096, 6144, 4096, 2) < vmem_footprint_bytes(
        128, 128, 128)
