"""The kernel-vs-plain limits of ``repro_torch.kernels.tolerance`` on the
CPU: a bf16 result of the right function, summed in another order, is
accepted; a decode that also reads keys past ``cur_len`` is refused, at
outputs far smaller than one (as decode's are at a long cache)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.kernels.tolerance import BF16_RTOL, F32_TOL, limits


def _decode_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in [(2, 4, 64), (2, 4, 2048, 64), (2, 4, 2048, 64)])
    return q, k, v


def _within(name, got, want):
    atol, rtol = limits(name, want)
    return torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", sorted(F32_TOL))
def test_float32_limits_are_the_kernel_tolerance(name):
    want = torch.ones(3, dtype=torch.float32)
    assert limits(name, want) == (F32_TOL[name], F32_TOL[name])


def test_bf16_limits_scale_with_the_output():
    want = torch.tensor([0.25, -0.5], dtype=torch.bfloat16)
    atol, rtol = limits("flash_decode", want)
    assert (atol, rtol) == (F32_TOL["flash_decode"] * 0.5, BF16_RTOL)
    with pytest.raises(ValueError, match="float16"):
        limits("flash_decode", want.half())


@pytest.mark.parametrize("cur_len", [300, 1000, 2048])
def test_bf16_decode_summed_in_float64_is_accepted(cur_len):
    q, k, v = _decode_inputs()
    want = flash_decode_plain(q, k, v, cur_len, block_kv=128)
    s = torch.einsum("bhd,bhsd->bhs", q.double(),
                     k[:, :, :cur_len].double()) * 64 ** -0.5
    f64 = torch.einsum("bhs,bhsd->bhd", torch.softmax(s, -1),
                       v[:, :, :cur_len].double()).to(torch.bfloat16)
    assert float(want.float().abs().max()) < 0.5
    assert _within("flash_decode", f64, want)


@pytest.mark.parametrize("cur_len", [2000, 2040])
def test_bf16_decode_reading_past_cur_len_is_refused(cur_len):
    q, k, v = _decode_inputs()
    want = flash_decode_plain(q, k, v, cur_len, block_kv=128)
    whole_block = -(-cur_len // 128) * 128
    wrong = flash_decode_plain(q, k, v, whole_block, block_kv=128)
    assert not _within("flash_decode", wrong, want)
