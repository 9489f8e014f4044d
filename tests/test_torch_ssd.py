"""The port's Mamba2 SSD chunk scan against the JAX package.

The plain version (what a CPU tensor runs) is the sequential recurrence;
it is held to the JAX Pallas kernel ``ssd_scan`` in interpret mode for
chunks 8, 16 and 32 and to the sequential oracle ``ssd_ref``, on inputs
made from a seed with numpy, at the tolerance of ``tests/test_kernels.py``
(2e-4, f32: the chunked form reorders the sums of the recurrence; bf16
inputs 2e-2, one bf16 rounding of the output).  The CUDA kernel runs only
on the card: ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip(
    "jax.numpy",
    reason="compares with the JAX reference package, not installed here")

from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd
from repro.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan import (
    LAUNCHES,
    smem_bytes,
    ssd_scan,
    ssd_scan_plain,
)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(b, s, h, p, n, dtype="float32", seed=0):
    """x, dt, A, Bm, Cm drawn with numpy: dt = softplus(z) / 2,
    A = -exp(0.3 z), B and C halved normals (the reference tests' law)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cast = [True, True, False, True, True]       # A stays f32
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    arrs = (x, dt, A, Bm, Cm)
    return ([torch.tensor(a).to(tdt) if c else torch.tensor(a)
             for a, c in zip(arrs, cast)],
            [jnp.asarray(a).astype(jdt) if c else jnp.asarray(a)
             for a, c in zip(arrs, cast)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("shape", [(1, 64, 2, 8, 16), (2, 64, 3, 8, 8)])
def test_plain_equals_jax_pallas_kernel(shape, chunk, dtype):
    args, jargs = _inputs(*shape, dtype=dtype)
    got = ssd_scan(*args, chunk=chunk)
    want = pallas_ssd(*jargs, chunk=chunk, interpret=True)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("shape", [(1, 64, 1, 8, 8), (2, 128, 3, 8, 16)])
def test_plain_equals_sequential_oracle(shape):
    args, jargs = _inputs(*shape, seed=1)
    np.testing.assert_allclose(_np(ssd_scan_plain(*args, chunk=32)),
                               _np(ssd_ref(*jargs)), atol=2e-4, rtol=2e-4)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    args, _ = _inputs(1, 32, 2, 4, 4)
    before = LAUNCHES.count
    ssd_scan(*args, chunk=16)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("bad", ["chunk", "dt", "B", "dtype"])
def test_rejects_what_the_jax_kernel_asserts(bad):
    (x, dt, A, Bm, Cm), _ = _inputs(1, 64, 2, 8, 8)
    kw = {"chunk": 16}
    if bad == "chunk":
        kw["chunk"] = 24
    elif bad == "dt":
        dt = dt[:, :, :1]
    elif bad == "B":
        Bm = Bm[:, :32]
    else:
        Cm = Cm.double()
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, **kw)


def test_smem_bytes_counts_state_vectors_and_pieces():
    # mamba2-1.3b (P = 64, N = 128, chunk 128) in f32: two C stages of
    # bf16 hi / lo (2 x 33,792), two B / x stages (2 x 50,176), the
    # state's hi / lo (32,768), three raw f32 boxes (24,576), the
    # mbarriers (256) and two 16-byte entries per 64-step tile, twice.
    assert smem_bytes(64, 128, 128) == (2 * 33792 + 2 * 50176 + 32768
                                        + 24576 + 256 + 64) == 225600
    # bf16: one piece, four B / x stages, no raw ring.
    assert smem_bytes(64, 128, 128, 2) == (2 * 17408 + 4 * 25600 + 32768
                                           + 256 + 64) == 170304
    # The chunk adds only its tile table: 32 bytes per 64 steps, so chunk
    # 4096 fits at full width.
    assert smem_bytes(64, 128, 4096) - smem_bytes(64, 128, 128) == 32 * 62
    assert smem_bytes(64, 128, 4096) <= 232448
    # P and N count padded to 64 or 128.
    assert smem_bytes(16, 32, 96) == smem_bytes(64, 64, 128)
    assert smem_bytes(128, 64, 128) == smem_bytes(65, 33, 65)
