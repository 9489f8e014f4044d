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
    ring_stages,
    smem_footprint_bytes,
    tma_loads,
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


# The kernel's shared memory, written out: a ring of S stages, each the A
# and B tiles of 32 k (2 x 128 x 32 elements) and two 8-byte mbarriers;
# S = clamp(ceil(block_k / 32), 2, what fits in 232,448 bytes); in f32 also
# the TF32 split tiles, 2 warpgroups x (64 + 128) rows x 32 x (hi, lo) x 4
# bytes = 98,304.
STAGE_BF16 = 2 * 128 * 32 * 2 + 16
STAGE_F32 = 2 * 128 * 32 * 4 + 16
SPLIT_F32 = 2 * (64 + 128) * 32 * 2 * 4


@pytest.mark.parametrize("knobs,dtype_bytes,want", [
    ((128, 128, 128), 2, 4 * STAGE_BF16),
    ((256, 256, 256), 4, SPLIT_F32 + 4 * STAGE_F32),   # 8 stages, capped
    ((104, 72, 56), 4, SPLIT_F32 + 2 * STAGE_F32),
    ((4, 128, 16), 4, SPLIT_F32 + 2 * STAGE_F32),      # at least 2
    ((8, 16, 8), 2, 2 * STAGE_BF16),
])
def test_smem_footprint_is_what_the_launch_requests(knobs, dtype_bytes,
                                                    want):
    assert smem_footprint_bytes(*knobs, dtype_bytes) == want
    dtype = torch.float32 if dtype_bytes == 4 else torch.bfloat16
    a, b = torch.zeros(16, 8, dtype=dtype), torch.zeros(8, 16, dtype=dtype)
    out = torch.empty(16, 16, dtype=dtype)
    args = _launch_args(a, b, out, *knobs)
    assert args[-1] == want and args[-2] == (dtype_bytes == 2)
    # Unlike the reference's VMEM footprint, it is bounded by the ring's
    # cap, not by the knobs: the planner's largest knobs fit one block.
    assert smem_footprint_bytes(4096, 6144, 4096, 2) <= 232448 < (
        vmem_footprint_bytes(4096, 6144, 4096))


@pytest.mark.parametrize("block_k,dtype_bytes,stages", [
    (1, 2, 2), (32, 2, 2), (33, 2, 2), (96, 2, 3), (128, 2, 4),
    (448, 2, 14), (4096, 2, 14), (64, 4, 2), (128, 4, 4), (4096, 4, 4),
])
def test_ring_stages_follow_block_k_within_the_clamp(block_k, dtype_bytes,
                                                     stages):
    """S = ceil(block_k / 32), at least 2, at most 14 stages in bf16
    (14 x 16,400 bytes) and 4 in f32 (98,304 + 4 x 32,784 bytes)."""
    assert ring_stages(block_k, dtype_bytes) == stages
    split = SPLIT_F32 if dtype_bytes == 4 else 0
    stage = STAGE_F32 if dtype_bytes == 4 else STAGE_BF16
    assert smem_footprint_bytes(128, 128, block_k, dtype_bytes) == (
        split + stages * stage)
    assert split + (stages + 1) * stage > 232448 or stages * 32 >= block_k


def test_f32_footprint_adds_the_split_tiles_at_equal_stages():
    for block_k in (64, 96, 128):
        s = ring_stages(block_k, 4)
        assert s == ring_stages(block_k, 2)
        assert (smem_footprint_bytes(128, 128, block_k, 4)
                - 2 * smem_footprint_bytes(128, 128, block_k, 2)
                == SPLIT_F32 - 16 * s)


def _offset(t: torch.Tensor, elements: int) -> torch.Tensor:
    """``t``'s values in a contiguous tensor whose base lies ``elements``
    elements past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
    return buf[elements:elements + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,a_off,b_off", [
    (64, 64, 0, 0), (53, 64, 0, 0), (64, 70, 0, 0), (64, 67, 0, 0),
    (64, 72, 0, 0), (64, 64, 1, 0), (64, 64, 0, 3), (48, 8, 0, 0),
])
def test_wrapper_takes_tma_exactly_when_rows_and_bases_are_16_byte_aligned(
        dtype, k, n, a_off, b_off):
    a = _offset(torch.zeros(12, k, dtype=dtype), a_off)
    b = _offset(torch.zeros(k, n, dtype=dtype), b_off)
    elt = a.element_size()
    aligned = (k * elt % 16 == 0 and n * elt % 16 == 0
               and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    assert aligned == (a_off == 0 and b_off == 0 and k * elt % 16 == 0
                       and n * elt % 16 == 0)
    assert tma_loads(a, b) == aligned
    out = torch.empty(12, n, dtype=dtype)
    assert _launch_args(a, b, out, 128, 128, 128)[-3] == int(aligned)
    # Either way the CPU runs the plain version on the same values.
    torch.testing.assert_close(cbp_matmul(a, b), cbp_matmul_plain(a, b),
                               rtol=0, atol=0)
