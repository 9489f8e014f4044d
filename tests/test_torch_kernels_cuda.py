"""The CUDA kernels against their plain versions, on the card: the
Lookahead greedy's edge cases and the kernel-level path's kernels.

Every test here needs an NVIDIA card and ``nvcc`` (the kernels have no
CPU interpret mode): each carries the ``cuda`` marker and skips without a
card.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_*.py

The file imports neither JAX nor the JAX package, which the card's
machine does not have; the CPU comparisons with the JAX package are in
``tests/test_torch_{planner,matmul,attention,decode,ssd}.py``.
The greedy must equal its plain version exactly.  The float kernels'
limits are those of ``repro_torch.kernels.tolerance``: in f32 atol =
rtol = 2e-5 (attention, decode), 1e-4 (matmul), 2e-4 (SSD against the
sequential recurrence); in bf16 rtol = 2^-7 (one bf16 ulp of the element)
and atol = the f32 tolerance times the largest output.
"""
import ctypes

import numpy as np
import pytest
import torch
from _torch_jax_ref import (
    GREEDY_EDGE_CASES,
    PLANNER_SPECS,
    greedy_edge_inputs,
)

from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.kernels import build
from repro_torch.kernels.cbp_matmul import (
    cbp_matmul,
    cbp_matmul_plain,
    smem_footprint_bytes,
    tma_loads,
)
from repro_torch.kernels.flash_attention import (
    attention_smem_bytes,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention import tma_loads as attention_tma
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.lookahead_greedy import (
    lookahead_greedy,
    lookahead_greedy_plain,
)
from repro_torch.kernels.ssd_scan import smem_bytes, ssd_scan, ssd_scan_plain
from repro_torch.kernels.tolerance import limits
from repro_torch.runtime import cbp_runtime as rt

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale)
    return x.to(device=dev, dtype=dtype)


def _close(name, got, want):
    assert got.dtype == want.dtype
    atol, rtol = limits(name, want)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _launched_once(name, fn):
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    return out


@pytest.mark.parametrize("name", GREEDY_EDGE_CASES)
def test_greedy_kernel_equals_plain_on_edge_cases(card, name):
    """Ties, cached best steps invalidated by the shrinking balance,
    remaining < U, all-inactive rows, min_units 0 and n * min_units = U,
    B = 1, B not a multiple of a block's rows, n > 32: bit for bit."""
    curves, mins, active, rem, U = (
        torch.as_tensor(x, device=card) if isinstance(x, np.ndarray) else x
        for x in greedy_edge_inputs(name))
    alloc, bal = _launched_once("lookahead_greedy", lambda: lookahead_greedy(
        curves, mins, active, rem, total_units=U))
    want = lookahead_greedy_plain(curves, mins, active, rem, total_units=U)
    assert torch.equal(alloc, want[0]) and torch.equal(bal, want[1])


def test_planner_on_the_card_one_launch_per_capacity_group(card):
    specs = []
    for spec in PLANNER_SPECS:
        s = {k: v for k, v in spec.items() if k != "vmem_budget"}
        if "vmem_budget" in spec:
            s["budget_bytes"] = spec["vmem_budget"]
        specs.append(s)
    groups = {max(s.get("budget_bytes", rt.DEFAULT_BUDGET_BYTES) // 8192, 6)
              for s in specs}
    reset_launch_counts()
    got = rt.plan_kernel_blocks(specs)
    assert launch_counts()["lookahead_greedy"] == len(groups)
    assert got == rt.plan_kernel_blocks(specs, device="cpu")


#: (m, k, n, block_m, block_n, block_k)
MATMUL_CASES = [
    (256, 128, 256, 64, 64, 64), (256, 128, 256, 128, 64, 32),
    (97, 53, 70, 104, 72, 56), (4, 128, 128, 4, 128, 128),
    (130, 96, 70, 32, 24, 40), (512, 512, 512, 256, 256, 256),
    # TMA loads (16-byte rows and bases), several tiles per region
    (384, 256, 512, 256, 256, 128),
    # the copy stage: K = 53, N = 70, N odd
    (64, 53, 136, 64, 136, 64), (96, 64, 67, 64, 64, 64),
    # regions that are not a multiple of the 128 tile
    (300, 96, 264, 104, 40, 24), (200, 64, 300, 24, 104, 40),
    # M < 64, and M <= 8 with the whole-extent block
    (40, 128, 256, 128, 128, 128), (8, 64, 136, 8, 136, 64),
    # block_k below two stages, and above the shared-memory cap
    (128, 256, 128, 128, 128, 8), (128, 512, 256, 128, 128, 4096),
    # K = 4096: the 3xTF32 accuracy in f32
    (256, 4096, 256, 128, 128, 128),
    # the planner's largest knobs: one block owns the matrix
    (300, 256, 400, 4096, 6144, 4096),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MATMUL_CASES)
def test_matmul_kernel_equals_plain(card, case, dtype):
    m, k, n, bm, bn, bk = case
    rng = np.random.default_rng(0)
    a, b = _randn(rng, (m, k), dtype, card), _randn(rng, (k, n), dtype, card)
    got = _launched_once("cbp_matmul", lambda: cbp_matmul(
        a, b, block_m=bm, block_n=bn, block_k=bk))
    _close("cbp_matmul", got, cbp_matmul_plain(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("a_off,b_off", [(0, 0), (1, 0), (0, 3)])
def test_matmul_kernel_equals_plain_on_unaligned_bases(card, dtype, a_off,
                                                       b_off):
    """Rows of 16-byte multiples, but a base off a 16-byte boundary takes
    the copy stage; aligned ones take TMA."""
    rng = np.random.default_rng(3)
    m, k, n = 192, 128, 256

    def at(shape, off):
        buf = torch.zeros(shape[0] * shape[1] + 16, dtype=dtype, device=card)
        t = buf[off:off + shape[0] * shape[1]].view(shape)
        return t.copy_(_randn(rng, shape, dtype, card))

    a, b = at((m, k), a_off), at((k, n), b_off)
    assert tma_loads(a, b) == (a_off == 0 and b_off == 0)
    got = _launched_once("cbp_matmul", lambda: cbp_matmul(a, b))
    _close("cbp_matmul", got, cbp_matmul_plain(a, b))


def test_matmul_shared_memory_equals_the_kernels_own_count(card):
    fn = build.load("cbp_matmul").cbp_matmul_smem_bytes
    fn.restype = ctypes.c_int
    for knobs in [(128, 128, 128), (256, 256, 256), (4, 128, 16),
                  (104, 72, 56), (4096, 6144, 4096), (8, 8, 1),
                  (128, 128, 96), (128, 128, 448), (128, 128, 480)]:
        for db in (2, 4):
            assert fn(*knobs, db) == smem_footprint_bytes(*knobs, db)


#: (B, H, Sq, Sk, Dh, block_q, block_kv[, variant]); variant "offset"
#: starts q, k and v one element into their storage (not 16-byte aligned:
#: the copy stage), "nan_tail" sets every key past the last query's
#: diagonal (Sq - 1) to NaN when causal: the output must not change.
ATTENTION_CASES = [
    (1, 2, 64, 64, 32, 32, 32), (1, 2, 64, 96, 32, 32, 32),
    (1, 4, 512, 512, 128, 256, 128), (1, 2, 320, 192, 64, 160, 96),
    (2, 3, 192, 320, 64, 64, 32),
    # zamba2-7b's head dim, the smoke configs' 16, and the planner's knobs
    # at the record shape
    (1, 2, 256, 256, 112, 128, 128), (1, 2, 256, 256, 16, 64, 64),
    (1, 4, 512, 512, 64, 256, 256),
    # rows of 18 elements are not 16-byte multiples: the copy stage
    (1, 2, 128, 256, 18, 64, 64),
    (1, 2, 192, 192, 64, 64, 64, "offset"),
    (1, 2, 128, 320, 128, 128, 64, "offset"),
    # the last key stage of a tile straddles Sq: it must end at the limit
    (1, 2, 96, 256, 64, 32, 32, "nan_tail"),
    (1, 2, 160, 320, 112, 160, 32, "nan_tail"),
]


def _at_offset(t, off):
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    storage."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    return buf[off:off + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_kernel_equals_plain(card, case, dtype, causal):
    B, H, Sq, Sk, D, bq, bkv = case[:7]
    variant = case[7] if len(case) > 7 else None
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, H, Sq, D), dtype, card)
    k, v = (_randn(rng, (B, H, Sk, D), dtype, card) for _ in range(2))
    if variant == "offset":
        q, k, v = (_at_offset(t, 1) for t in (q, k, v))
        assert q.is_contiguous() and not attention_tma(q, k, v)
    want = flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                 block_kv=bkv)
    got = _launched_once("flash_attention", lambda: flash_attention(
        q, k, v, causal=causal, block_q=bq, block_kv=bkv))
    _close("flash_attention", got, want)
    if variant == "nan_tail" and causal:
        k[:, :, Sq:], v[:, :, Sq:] = float("nan"), float("nan")
        poisoned = flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_kv=bkv)
        assert torch.equal(poisoned, got)


def test_attention_shared_memory_equals_the_kernels_own_count(card):
    fn = build.load("flash_attention").flash_attention_smem_bytes
    fn.restype = ctypes.c_int
    for dh in range(1, 129):
        for db in (2, 4):
            assert fn(dh, db) == attention_smem_bytes(dh, db)


def test_attention_refuses_a_head_dim_it_cannot_stage(card):
    q = torch.zeros(1, 1, 64, 192, device=card)
    with pytest.raises(ValueError, match="128"):
        flash_attention(q, q, q, block_q=64, block_kv=64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cur_len", [0, 1, 300, 512, 2048])
@pytest.mark.parametrize("block_kv", [64, 128, 2048])
def test_decode_kernel_equals_plain(card, cur_len, dtype, block_kv):
    rng = np.random.default_rng(2)
    q = _randn(rng, (2, 4, 64), dtype, card)
    kc, vc = (_randn(rng, (2, 4, 2048, 64), dtype, card) for _ in range(2))
    lens = torch.tensor(cur_len, dtype=torch.int32, device=card)
    got = _launched_once("flash_decode", lambda: flash_decode(
        q, kc, vc, lens, block_kv=block_kv))
    _close("flash_decode", got,
           flash_decode_plain(q, kc, vc, lens, block_kv=block_kv))
    if cur_len == 0:
        assert not got.float().abs().sum()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_kv", [64, 128, 512, 2048])
@pytest.mark.parametrize("dh", [64, 96, 128, 256])
@pytest.mark.parametrize("cur_len", [1, 7, 129, 2047])
def test_decode_kernel_equals_plain_across_head_dims(card, cur_len, dh,
                                                     block_kv, dtype):
    rng = np.random.default_rng(5)
    q = _randn(rng, (1, 3, dh), dtype, card)
    kc, vc = (_randn(rng, (1, 3, 2048, dh), dtype, card) for _ in range(2))
    got = _launched_once("flash_decode", lambda: flash_decode(
        q, kc, vc, cur_len, block_kv=block_kv))
    _close("flash_decode", got,
           flash_decode_plain(q, kc, vc, cur_len, block_kv=block_kv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh,cur_len", [(64, 77), (128, 131), (96, 1029),
                                        (256, 333), (33, 45)])
def test_decode_never_reads_the_poisoned_tail(card, dh, cur_len, dtype):
    """NaN past cur_len would reach the output if a key there were loaded;
    cur_len falls inside a group of keys that share a warp load."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2, 2, dh), dtype, card)
    kc, vc = (_randn(rng, (2, 2, 1024 + 256, dh), dtype, card)
              for _ in range(2))
    want = flash_decode_plain(q, kc, vc, cur_len, block_kv=128)
    clean = flash_decode(q, kc, vc, cur_len, block_kv=128)
    kc[:, :, cur_len:], vc[:, :, cur_len:] = float("nan"), float("nan")
    got = flash_decode(q, kc, vc, cur_len, block_kv=128)
    assert torch.equal(got, clean)
    _close("flash_decode", got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_reads_a_cache_that_is_not_16_byte_aligned(card, dtype):
    """A contiguous cache one element into its storage cannot take 16-byte
    loads; the kernel reads it an element a lane."""
    rng = np.random.default_rng(7)
    shape = (2, 2, 512, 128)
    q = _randn(rng, (2, 2, 128), dtype, card)
    kc, vc = (torch.cat([torch.zeros(1, dtype=dtype, device=card),
                         _randn(rng, shape, dtype, card).flatten()])[1:]
              .view(shape) for _ in range(2))
    assert kc.is_contiguous() and kc.data_ptr() % 16
    got = _launched_once("flash_decode", lambda: flash_decode(
        q, kc, vc, 300, block_kv=128))
    _close("flash_decode", got, flash_decode_plain(q, kc, vc, 300,
                                                   block_kv=128))


def test_decode_refuses_a_head_dim_past_its_limit(card):
    q = torch.zeros(1, 1, 264, device=card)
    kc = torch.zeros(1, 1, 64, 264, device=card)
    with pytest.raises(ValueError, match="256"):
        flash_decode(q, kc, kc, 10, block_kv=64)


def test_decode_takes_a_python_int_and_ignores_the_tail(card):
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 2, 128), torch.float32, card)
    kc, vc = (_randn(rng, (1, 2, 256, 128), torch.float32, card)
              for _ in range(2))
    out = flash_decode(q, kc, vc, 77, block_kv=64)
    kc[:, :, 77:], vc[:, :, 77:] = 1e6, -1e6
    torch.testing.assert_close(flash_decode(q, kc, vc, 77, block_kv=64),
                               out, atol=1e-6, rtol=0)


def _ssd_inputs(rng, b, s, h, p, n, dtype, dev, dt_scale=0.5):
    """x, dt, A, Bm, Cm with the smoke's law: dt = softplus(z) dt_scale,
    A = -exp(0.3 z), B and C halved normals."""
    x = _randn(rng, (b, s, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(
        _randn(rng, (b, s, h), torch.float32, dev)).mul(dt_scale).to(dtype)
    A = -torch.exp(_randn(rng, (h,), torch.float32, dev, 0.3))
    Bm, Cm = (_randn(rng, (b, s, n), dtype, dev, 0.5) for _ in range(2))
    return x, dt, A, Bm, Cm


def _ssd_close(args, chunk):
    got = _launched_once("ssd_scan", lambda: ssd_scan(*args, chunk=chunk))
    assert torch.isfinite(got.float()).all()
    _close("ssd_scan", got, ssd_scan_plain(*args, chunk=chunk))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [8, 32, 96, 128, 384])
def test_ssd_kernel_equals_plain(card, chunk, dtype):
    rng = np.random.default_rng(4)
    _ssd_close(_ssd_inputs(rng, 2, 384, 3, 16, 32, dtype, card), chunk)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,chunk", [(4096, 4096), (288, 96), (96, 32),
                                     (200, 40)])
def test_ssd_chunk_spans_and_partial_tiles(card, s, chunk, dtype):
    """Chunk 4096 (the planner's at its default budget) over S = 4096; S
    a multiple of the chunk but not of the kernel's 64-step tile."""
    rng = np.random.default_rng(5)
    _ssd_close(_ssd_inputs(rng, 1, s, 2, 16, 32, dtype, card), chunk)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,n", [(128, 64), (64, 128), (96, 40), (5, 7)])
def test_ssd_state_shapes(card, p, n, dtype):
    """Both shapes at P * N = 8192, and P, N padded inside a tile."""
    rng = np.random.default_rng(6)
    _ssd_close(_ssd_inputs(rng, 1, 256, 2, p, n, dtype, card), 128)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["x", "B", "C", "all"])
def test_ssd_reads_bases_off_16_bytes(card, dtype, which):
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, 192, 3, 16, 32, dtype, card)
    if which in ("x", "all"):
        x = _at_offset(x, 1)
    if which in ("B", "all"):
        Bm = _at_offset(Bm, 1)
    if which in ("C", "all"):
        Cm = _at_offset(Cm, 1)
    assert all(t.is_contiguous() for t in (x, Bm, Cm))
    _ssd_close((x, dt, A, Bm, Cm), 96)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("s,chunk", [(192, 96), (64, 8)])
def test_ssd_next_chunk_never_reaches_the_outputs(card, s, chunk, offset,
                                                 dtype):
    """A chunk that ends inside a 64-step tile: NaN in every later step
    leaves the first chunk's outputs bit for bit (TMA and copy loads)."""
    rng = np.random.default_rng(9)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, s, 2, 16, 32, dtype, card)
    if offset:
        x, Bm, Cm = (_at_offset(t, offset) for t in (x, Bm, Cm))
    clean = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    for t in (x, dt, Bm, Cm):
        t[:, chunk:] = float("nan")
    poisoned = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(poisoned[:, :chunk], clean[:, :chunk])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_steep_decay_over_a_long_chunk(card, dtype):
    """dt ~ 4 softplus(z): cs falls by ~3 a step, to ~-12,000 over chunk
    4096, where exp(-cs_j) overflows; every output finite and within the
    limits."""
    rng = np.random.default_rng(8)
    _ssd_close(_ssd_inputs(rng, 1, 4096, 2, 16, 32, dtype, card,
                           dt_scale=4.0), 4096)


def test_ssd_shared_memory_equals_the_kernels_own_count(card):
    fn = build.load("ssd_scan").ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    for p, n, chunk in [(64, 128, 128), (128, 64, 4096), (16, 32, 96),
                        (8, 8, 4096), (5, 7, 8), (64, 64, 20000)]:
        for db in (2, 4):
            assert fn(p, n, chunk, db) == smem_bytes(p, n, chunk, db)


def test_ssd_refuses_a_state_it_cannot_hold(card):
    x = torch.zeros(1, 64, 1, 128, device=card)
    dt, A = torch.zeros(1, 64, 1, device=card), torch.zeros(1, device=card)
    Bm = torch.zeros(1, 64, 128, device=card)
    with pytest.raises(ValueError, match="8192"):
        ssd_scan(x, dt, A, Bm, Bm, chunk=64)
