"""Parts of the port's model stack on the CPU, without a JAX subprocess:
the configs against the reference's (every field and derived property of
all 20), ``params_from_jax``'s checks, the decode cache's write paths
(``onehot`` against ``dus``, a per-row ``cur_len`` against the scalar
one), the MoE overflow rule (ROADMAP R3) on a routing built by hand, the
meta-device input specs, and ``build``'s refusal to run without a card
unless the CPU is asked.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_model_ref import flatten

from repro import configs as ref_configs
from repro.models import build as ref_build

from repro_torch import configs
from repro_torch.models import SHAPES, build, params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.models.attention import causal_attention

NAMES = configs.names()
DERIVED = ("head_dim", "padded_heads", "heads_shardable", "padded_experts",
           "moe_ep", "padded_vocab", "d_inner", "ssm_heads", "n_rep")
#: (mesh_model, dp) settings that exercise the padding rules (yi-34b's 56
#: heads -> 64 on 16; 8 grok experts on a 16-way axis stay unpadded).
MESHES = ((1, 1), (16, 4), (8, 2))


def assert_same_config(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for name in DERIVED:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_config_names_equal_the_reference():
    assert NAMES == ref_configs.names()
    assert len(NAMES) == 10


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_config_fields_and_derived_equal_the_reference(name, smoke, mesh):
    get = "get_smoke" if smoke else "get"
    port = getattr(configs, get)(name).with_mesh(*mesh)
    ref = getattr(ref_configs, get)(name).with_mesh(*mesh)
    assert_same_config(port, ref)


# ------------------------------------------------------------------ #
# params_from_jax
# ------------------------------------------------------------------ #


def numpy_tree(cfg, seed=0):
    """A parameter tree of the port's layout as nested dicts of numpy
    arrays (what the JAX package's ``Model.init`` gives, in values)."""
    rng = np.random.default_rng(seed)

    def leaf(t):
        a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16 if t.dtype == torch.bfloat16
                        else str(t.dtype).removeprefix("torch."))

    return L.tree_map(leaf, model_mod.init_params(cfg, None, "meta"))


@pytest.mark.parametrize("name", NAMES)
def test_converter_carries_every_leaf(name):
    cfg = configs.get_smoke(name)
    tree = numpy_tree(cfg)
    model = params_from_jax(cfg, tree, device="cpu")
    flat_port = dict(model.named_parameters())
    assert len(flat_port) == len(flatten(tree))
    for path, value in flatten(tree).items():
        got = flat_port["weights." + path.replace("/", ".")]
        np.testing.assert_array_equal(got.numpy(), value)


def test_converter_keeps_bfloat16_bits():
    cfg = dataclasses.replace(configs.get_smoke("qwen3-8b"),
                              param_dtype="bfloat16")
    tree = numpy_tree(cfg)
    model = params_from_jax(cfg, tree, device="cpu")
    wq = model.params["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), tree["layers"]["attn"]["wq"].astype(np.float32))
    assert model.params["layers"]["attn"]["q_norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["missing", "unused", "shape", "dtype",
                                   "not_a_dict"])
def test_converter_raises_on_a_bad_leaf(fault):
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    tree = numpy_tree(cfg)
    moe = tree["layers"]["moe"]
    if fault == "missing":
        del moe["wu"]
        err, match = KeyError, "missing leaves.*layers/moe/wu"
    elif fault == "unused":
        moe["bias"] = np.zeros(3, np.float32)
        err, match = KeyError, "unused leaves.*layers/moe/bias"
    elif fault == "shape":
        moe["router"] = moe["router"][:, :, :-1]
        err, match = ValueError, "layers/moe/router: shape"
    elif fault == "dtype":
        moe["router"] = moe["router"].astype(np.float64)
        err, match = ValueError, "layers/moe/router: dtype float64"
    else:
        tree["layers"] = list(tree["layers"].values())
        err, match = TypeError, "/layers: expected a dict"
    with pytest.raises(err, match=match):
        params_from_jax(cfg, tree, device="cpu")


# ------------------------------------------------------------------ #
# decode cache writes
# ------------------------------------------------------------------ #


def decode_run(cfg, tokens, positions, max_len=16, seed=0):
    """Logits and caches of decode steps at ``positions`` (scalars or
    per-row lists) from one model drawn from ``seed``."""
    model = build(cfg, device="cpu", seed=seed)
    cache = model.init_cache(tokens.shape[0], max_len, dtype=torch.float32)
    logits = []
    for i, pos in enumerate(positions):
        out, cache = model.decode_step(cache, tokens[:, i:i + 1], pos)
        logits.append(out)
    return torch.cat(logits, dim=1), cache


@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-7b", "whisper-tiny"])
def test_onehot_and_dus_writes_give_equal_caches(name):
    cfg = configs.get_smoke(name)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    runs = [decode_run(dataclasses.replace(cfg, decode_cache_update=mode),
                       tokens, range(6)) for mode in ("onehot", "dus")]
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb)
    assert ca.keys() == cb.keys()
    for key in ca:
        assert torch.equal(ca[key], cb[key]), key


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-moe-30b-a3b",
                                  "zamba2-7b"])
def test_vector_cur_len_equals_scalar_on_equal_positions(name):
    cfg = dataclasses.replace(configs.get_smoke(name), capacity_factor=8.0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(2))
    ls, cs = decode_run(cfg, tokens, range(5))
    lv, cv = decode_run(cfg, tokens, [[i, i] for i in range(5)])
    assert torch.equal(ls, lv)
    for key in cs:
        assert torch.equal(cs[key], cv[key]), key


def test_vector_cur_len_puts_each_row_at_its_own_position():
    """Row 1 runs two steps ahead of row 0; each row equals its own
    scalar run (B = 1) at its positions, within float32 rounding (the
    matmuls of one row and of two block differently).  Both leave the
    positions before row 1's first step zero."""
    cfg = configs.get_smoke("qwen3-8b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 4),
                           generator=torch.Generator().manual_seed(3))
    rows = [[0, 2], [1, 3], [2, 4], [3, 5]]
    lv, cv = decode_run(cfg, tokens, rows)
    for r in range(2):
        positions = [p[r] for p in rows]
        ls, cs = decode_run(cfg, tokens[r:r + 1], positions)
        torch.testing.assert_close(lv[r:r + 1], ls, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(cv["k"][:, r:r + 1], cs["k"],
                                   rtol=1e-4, atol=1e-5)


def test_writes_past_the_cache_follow_the_reference():
    """At ``cur_len == max_len`` the one-hot and per-row writes drop the
    entry (masked select; scatter's drop mode); ``dus`` clamps its start
    into the cache, as ``dynamic_update_slice`` does."""
    cfg = configs.get_smoke("qwen3-8b")
    g = torch.Generator().manual_seed(4)
    cache = torch.randn(2, 4, 2, 16, generator=g)
    new = torch.randn(2, 1, 2, 16, generator=g)
    at = torch.tensor(4)
    onehot = transformer._write_cache(cfg, cache, new, at)
    per_row = transformer._write_cache(cfg, cache, new, torch.tensor([4, 1]))
    dus = transformer._write_cache(
        dataclasses.replace(cfg, decode_cache_update="dus"), cache, new, at)
    assert torch.equal(onehot, cache)
    assert torch.equal(per_row[0], cache[0])
    assert torch.equal(per_row[1, 1], new[1, 0])
    assert torch.equal(dus[:, 3], new[:, 0])
    assert torch.equal(dus[:, :3], cache[:, :3])


# ------------------------------------------------------------------ #
# MoE overflow (R3), attention chunks
# ------------------------------------------------------------------ #


def test_moe_overflow_leaves_the_last_slot_empty():
    """Every token prefers expert 0: it receives T assignments for C < T
    slots and serves positions < C - 1 only (the reference's dispatch
    scatter writes the sentinel over slot C - 1); expert 1, the second
    choice of exactly C tokens, keeps all C; expert 2, the others' second
    choice, overflows too."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-moe-30b-a3b"),
                              capacity_factor=1.0)
    d, e = cfg.d_model, cfg.padded_experts
    t = 16
    cap = transformer.moe_capacity(cfg, t)            # 16 * 2 / 8 = 4
    x = torch.zeros(1, t, d)
    x[0, :, 0] = 1.0
    x[0, :cap, 1] = 0.5           # the first C tokens' second choice is 1
    x[0, cap:, 2] = 0.5           # the others' is 2
    router = torch.full((d, e), -1.0)
    for j in range(3):
        router[j, j] = 10.0
    route = transformer.moe_route({"router": router}, cfg, x)
    kept = (route.slots[0] < t * cfg.top_k).sum(-1)
    assert route.experts[0, :, 0].eq(0).all()
    assert kept[:3].tolist() == [cap - 1, cap, cap - 1]
    assert kept[3:].eq(0).all()
    # slot ids rise with the token: expert 0 keeps tokens 0 .. C-2
    assert route.slots[0, 0, :cap - 1].tolist() == [
        i * cfg.top_k for i in range(cap - 1)]
    assert route.slots[0, 0, cap - 1] == t * cfg.top_k


@pytest.mark.parametrize("chunk", [4, 5, 12, 64])
def test_chunked_attention_equals_one_chunk(chunk):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 12, 4, 16, generator=g) for _ in range(3))
    whole = causal_attention(q, k, v, chunk=12)
    torch.testing.assert_close(causal_attention(q, k, v, chunk=chunk), whole,
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ #
# facade
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("name", NAMES)
def test_input_specs_and_shape_support_equal_the_reference(name):
    port = model_mod.Model(configs.get(name), {"x": torch.zeros(1)})
    ref = ref_build(ref_configs.get(name))
    for shape in SHAPES:
        got, want = port.input_specs(shape), ref.input_specs(shape)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].is_meta
            assert tuple(got[key].shape) == tuple(want[key].shape)
            assert str(got[key].dtype).removeprefix("torch.") == str(
                want[key].dtype)
        assert port.supports_shape(shape) == ref.supports_shape(shape)


def test_build_raises_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("qwen3-8b")
    for call in (lambda: build(cfg),
                 lambda: params_from_jax(cfg, numpy_tree(cfg))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert build(cfg, device="cpu").device.type == "cpu"


def test_build_draws_from_the_seed():
    cfg = configs.get_smoke("zamba2-7b")
    a, b = build(cfg, device="cpu", seed=5), build(cfg, device="cpu", seed=5)
    c = build(cfg, device="cpu", seed=6)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
    assert not torch.equal(a.params["embed"], c.params["embed"])
    # fan-in truncated normal: |w| <= 2 / sqrt(fan_in)
    wx = a.params["layers"]["wx"]
    assert float(wx.abs().max()) <= 2.0 / cfg.d_model ** 0.5


def ssd_sequential(x, dt, A, Bm, Cm):
    """The SSD recurrence step by step: h_t = exp(dt_t A) h_{t-1}
    + dt_t x_t (x) B_t, y_t = C_t . h_t (float64)."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    b, s, h, p = x.shape
    state = torch.zeros(b, h, p, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * A)[:, :, None, None] * state
                 + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                                Bm[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_inputs(s, dt_scale, seed=7):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, s, 3, 8, generator=g)
    dt = torch.rand(2, s, 3, generator=g) * dt_scale
    A = -torch.rand(3, generator=g) - 0.5
    Bm, Cm = (torch.randn(2, s, 4, generator=g) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_chunked_equals_the_recurrence_in_any_chunk(chunk):
    """The chunk length is a numerics setting: every chunking computes the
    recurrence (so phase 14 may run a full-width SSM in chunks of 16)."""
    from repro_torch.models.ssm import ssd_chunked

    inp = ssd_inputs(64, 0.5)
    y, state = ssd_chunked(*inp, chunk=chunk)
    y_ref, state_ref = ssd_sequential(*inp)
    torch.testing.assert_close(y.double(), y_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(state.double(), state_ref, rtol=1e-4,
                               atol=1e-5)


def test_ssd_chunked_overflows_as_the_reference_does():
    """ROADMAP R5: the reference takes exp(cs_i - cs_j) over the whole
    chunk before its causal mask; once a chunk's decay passes e^88 the
    entries above the diagonal are inf and inf x 0 is NaN.  The port keeps
    that (here 64 steps of dt ~ 1.5 and A ~ -1 in one chunk), and the
    same inputs in chunks of 16 stay finite and exact."""
    from repro_torch.models.ssm import ssd_chunked

    inp = ssd_inputs(64, 3.0)
    y, _ = ssd_chunked(*inp, chunk=64)
    assert torch.isnan(y).any()
    y16, _ = ssd_chunked(*inp, chunk=16)
    torch.testing.assert_close(y16.double(), ssd_sequential(*inp)[0],
                               rtol=1e-4, atol=1e-5)
