"""The port's flash-attention forward against the JAX package.

The plain version (what a CPU tensor runs) is held to the JAX Pallas
kernel ``flash_attention_fwd`` in interpret mode and to its oracle
``attention_ref``, on inputs made from a seed with numpy, causal and not,
with ``Sq == Sk`` and ``Sq != Sk`` (the causal mask is top-left aligned),
at the tolerances of ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2).
The CUDA kernel itself runs only on the card:
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip(
    "jax.numpy",
    reason="compares with the JAX reference package, not installed here")

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (
    LAUNCHES,
    attention_smem_bytes,
    flash_attention,
    flash_attention_plain,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: (B, H, Sq, Sk, Dh, block_q, block_kv)
SHAPES = [(1, 2, 64, 64, 32, 32, 32), (1, 2, 64, 64, 32, 64, 32),
          (1, 2, 64, 96, 32, 32, 32),
          # the smoke configs' head dim and zamba2-7b's
          (1, 2, 64, 64, 16, 32, 32), (1, 1, 64, 96, 112, 32, 32)]


def _qkv(shape, dtype, seed=0):
    B, H, Sq, Sk, D = shape[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, s, D)).astype(np.float32)
            for s in (Sq, Sk, Sk)]
    return ([torch.tensor(x).to(getattr(torch, dtype)) for x in arrs],
            [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_jax_pallas_kernel(shape, dtype, causal):
    bq, bkv = shape[5:]
    (q, k, v), (jq, jk, jv) = _qkv(shape, dtype)
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
    want = flash_attention_fwd(jq, jk, jv, causal=causal, block_q=bq,
                               block_kv=bkv, interpret=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 128, 128, 64), (1, 2, 64, 160, 32),
                                   (1, 2, 64, 64, 16), (1, 1, 64, 96, 112)])
def test_plain_equals_oracle(shape, causal):
    (q, k, v), (jq, jk, jv) = _qkv(shape, "float32", seed=1)
    np.testing.assert_allclose(
        _np(flash_attention_plain(q, k, v, causal=causal, block_q=32,
                                  block_kv=32)),
        _np(attention_ref(jq, jk, jv, causal=causal)), atol=2e-5,
        rtol=2e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    (q, k, v), _ = _qkv((1, 1, 32, 32, 16), "float32")
    before = LAUNCHES.count
    torch.testing.assert_close(
        flash_attention(q, k, v, block_q=16, block_kv=16),
        flash_attention_plain(q, k, v, block_q=16, block_kv=16),
        rtol=0, atol=0)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("bad", ["block_q", "block_kv", "shape", "dtype"])
def test_rejects_what_the_jax_kernel_asserts(bad):
    q = k = v = torch.zeros(1, 2, 64, 16)
    kw = {"block_q": 32, "block_kv": 32}
    if bad == "block_q":
        kw["block_q"] = 48
    elif bad == "block_kv":
        kw["block_kv"] = 40
    elif bad == "shape":
        k = torch.zeros(1, 2, 64, 8)
    else:
        v = v.double()
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_kernel_shared_memory_fits_a_block_at_every_head_dim(dtype_bytes):
    """The kernel's shared memory (Q tile, K/V ring, float32 split tiles)
    fits the 232,448 bytes an H100 block may use, for every head dim the
    wrapper accepts; Dh pads to 64 or 128."""
    sizes = [attention_smem_bytes(dh, dtype_bytes) for dh in range(1, 129)]
    assert max(sizes) <= 232448
    assert sizes[0] == sizes[63] < sizes[64] == sizes[127]
