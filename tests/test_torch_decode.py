"""The port's flash decode against the JAX package.

The plain version (what a CPU tensor runs) is held to the JAX Pallas
kernel ``flash_decode`` in interpret mode at ``cur_len`` 0 (zeros, from
the kernel's ``max(l, 1e-30)``), inside a block and at ``Smax``, given as
an int and as a 0-d int32 tensor, and to its oracle ``decode_ref`` (which
has no zero-length case), on inputs made from a seed with numpy, at the
tolerances of ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2).  The CUDA
kernels run only on the card: ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip(
    "jax.numpy",
    reason="compares with the JAX reference package, not installed here")

from repro.kernels.flash_decode.kernel import flash_decode as pallas_decode
from repro.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.flash_decode import (
    LAUNCHES,
    flash_decode,
    flash_decode_plain,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, H, SMAX, DH = 2, 2, 128, 32


def _inputs(dtype, seed=0, smax=SMAX):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, DH), (B, H, smax, DH), (B, H, smax, DH))]
    return ([torch.tensor(x).to(getattr(torch, dtype)) for x in arrs],
            [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("block_kv", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", [0, 50, SMAX])
def test_plain_equals_jax_pallas_kernel(cur_len, dtype, block_kv,
                                        as_tensor):
    (q, k, v), (jq, jk, jv) = _inputs(dtype)
    lens = (torch.tensor(cur_len, dtype=torch.int32) if as_tensor
            else cur_len)
    got = flash_decode(q, k, v, lens, block_kv=block_kv)
    want = pallas_decode(jq, jk, jv, jnp.asarray(cur_len, jnp.int32),
                         block_kv=block_kv, interpret=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if cur_len == 0:
        assert not _np(got).any()


@pytest.mark.parametrize("cur_len", [1, 77, SMAX])
def test_plain_equals_oracle(cur_len):
    (q, k, v), (jq, jk, jv) = _inputs("float32", seed=1)
    np.testing.assert_allclose(
        _np(flash_decode_plain(q, k, v, cur_len, block_kv=64)),
        _np(decode_ref(jq, jk, jv, cur_len)), atol=2e-5, rtol=2e-5)


def test_cache_tail_past_cur_len_is_ignored():
    (q, k, v), _ = _inputs("float32", seed=2)
    out1 = flash_decode(q, k, v, 77, block_kv=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 77:] = 1e6
    v2[:, :, 77:] = -1e6
    torch.testing.assert_close(flash_decode(q, k2, v2, 77, block_kv=32),
                               out1, rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    (q, k, v), _ = _inputs("float32")
    before = LAUNCHES.count
    flash_decode(q, k, v, torch.tensor(9), block_kv=64)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("bad", ["block_kv", "shape", "cur_len"])
def test_rejects_what_the_jax_kernel_asserts(bad):
    (q, k, v), _ = _inputs("float32")
    kw, lens = {"block_kv": 64}, 10
    if bad == "block_kv":
        kw["block_kv"] = 48
    elif bad == "shape":
        k = k[:, :1]
    else:
        lens = torch.tensor(1.5)
    with pytest.raises(ValueError):
        flash_decode(q, k, v, lens, **kw)
