"""Parts of the port's serving path on the CPU.

* ``repro_torch.serving.kv_cache`` is a copy of the reference's
  ``PagedKVPool`` (both numpy, in process): on random access traces with
  readahead touches and reconfigurations between them, every hit,
  partition, counter, occupancy and utility curve is the reference's.
* The device engine's admission (``engine_graph.admit``, a fixed unroll
  of ``slots per group`` bodies) equals a while loop over the same body
  (the reference's ``lax.while_loop``) on random queue states.
* The float32 cumulative stack-distance histogram, cast to float64 for
  the greedy, is exact: the cast curve equals the float64 cumulative sum
  of the same counts, and the greedy's partition on it is the numpy
  golden's.
* ``Model.decode_step(..., inplace=True)`` writes the new cache rows in
  place and is bit-identical to the out-of-place step (dense, MoE, SSM,
  hybrid, encoder-decoder, int8 cache; per-row and scalar positions, the
  ``onehot`` and ``dus`` writes) over 12 steps.
* The launcher ``python -m repro_torch.launch.serve --device cpu`` serves
  its requests with either engine, and with ``--groups 2`` on two forced
  devices prints the grid it planned and the device of each block.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch import configs
from repro_torch.core import cache_controller_numpy
from repro_torch.models import build
from repro_torch.serving import PagedKVPool
from repro_torch.serving.engine_graph import admission_body, admit

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread runs their small ops
    fastest, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# the paged KV pool
# ------------------------------------------------------------------ #

def pool_trace(seed: int, n_streams: int, n_ops: int):
    """Accesses (stream, key, prefetch) over a few hot keys a stream, with
    a reconfiguration now and then (None)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        if rng.random() < 0.05:
            yield None
        else:
            s = int(rng.integers(n_streams))
            yield s, (s, int(rng.integers(12))), bool(rng.random() < 0.3)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       n_streams=st.integers(min_value=1, max_value=4),
       backend=st.integers(min_value=0, max_value=1))
def test_pool_is_the_reference_pool(seed, n_streams, backend):
    from repro.serving.kv_cache import PagedKVPool as RefPool

    name = ("numpy", "jax")[backend]
    ours = PagedKVPool(24, n_streams, allocator_backend=name)
    theirs = RefPool(24, n_streams)
    for op in pool_trace(seed, n_streams, 300):
        if op is None:
            got, want = ours.reconfigure(), theirs.reconfigure()
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
        else:
            assert ours.access(*op[:2], prefetch=op[2]) == theirs.access(
                *op[:2], prefetch=op[2])
    np.testing.assert_array_equal(ours.partition, theirs.partition)
    np.testing.assert_array_equal(ours.occupancy(), theirs.occupancy())
    np.testing.assert_array_equal(ours.utility_curves(),
                                  theirs.utility_curves())
    assert [dataclasses.astuple(s) for s in ours.stats] == \
        [dataclasses.astuple(s) for s in theirs.stats]
    assert [s.hit_rate for s in ours.stats] == \
        [s.hit_rate for s in theirs.stats]


def test_pool_refuses_a_floor_past_its_pages():
    with pytest.raises(ValueError, match="min_pages"):
        PagedKVPool(7, 4)


# ------------------------------------------------------------------ #
# admission: fixed unroll against the while loop
# ------------------------------------------------------------------ #

def queue_state(seed: int, G: int, spg: int, npg: int, R: int):
    """A random mid-run queue state: some slots busy, some requests
    admitted or done, pending counts that agree with them."""
    rng = np.random.default_rng(seed)
    req_stream = rng.integers(0, npg, (G, R))
    admitted = rng.random((G, R)) < 0.4
    done = admitted & (rng.random((G, R)) < 0.5)
    pend = np.zeros((G, npg), dtype=np.int32)
    for g in range(G):
        for r in range(R):
            if not admitted[g, r]:
                pend[g, req_stream[g, r]] += 1
    t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt)
    c = {"active": t(rng.random((G, spg)) < 0.4, torch.bool),
         "slot_req": t(rng.integers(0, R, (G, spg))),
         "slot_stream": t(rng.integers(0, npg, (G, spg))),
         "pos": t(rng.integers(0, 9, (G, spg))),
         "tokens": t(rng.integers(0, 50, (G, spg))),
         "stream_active": t(rng.integers(0, spg + 1, (G, npg))),
         "pend_count": t(pend),
         "queue_wait": t(rng.integers(0, 20, (G, npg)) / 4, torch.float32),
         "admitted": t(admitted, torch.bool)}
    ctx = {"live": t(rng.random(G) < 0.8, torch.bool),
           "done": t(done, torch.bool),
           "slot_share": t(rng.integers(1, 9, (G, npg)) / 4, torch.float32),
           "req_stream": t(req_stream),
           "prompts": t(rng.integers(0, 50, (G, R, 3))),
           "enqueue_step": t(rng.integers(0, 5, (G, R))),
           "steps": t(rng.integers(5, 30, G))}
    return c, ctx


def admission_pending(c, ctx) -> bool:
    """The reference's admission ``while`` condition (``engine_jax.py``
    ``adm_cond``): some live group has an empty slot and a pending
    request."""
    return bool((ctx["live"] & (~c["active"]).any(-1)
                 & (c["pend_count"].sum(-1) > 0)).any())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       G=st.integers(min_value=1, max_value=3),
       spg=st.integers(min_value=1, max_value=6),
       npg=st.integers(min_value=1, max_value=4),
       R=st.integers(min_value=1, max_value=12))
def test_admission_unroll_equals_the_while_loop(seed, G, spg, npg, R):
    c, ctx = queue_state(seed, G, spg, npg, R)
    loop, trips = dict(c), 0
    while admission_pending(loop, ctx):
        after = admission_body(loop, ctx)
        if all(torch.equal(after[k], loop[k]) for k in loop):
            break                    # nothing admittable: a no-op trip
        loop, trips = after, trips + 1
    assert trips <= spg
    unrolled = admit(c, ctx)
    for key in c:
        assert torch.equal(unrolled[key], loop[key]), key
    # one more trip changes nothing
    extra = admission_body(unrolled, ctx)
    assert all(torch.equal(extra[k], unrolled[k]) for k in c)


# ------------------------------------------------------------------ #
# the greedy's curves: float32 histogram, cast to float64
# ------------------------------------------------------------------ #

@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       halvings=st.integers(min_value=0, max_value=12))
def test_float32_curves_cast_exactly(seed, halvings):
    """Counts added one at a time and halved at each reconfiguration (the
    engine's histogram): the float32 cumulative sum cast to float64
    equals the float64 sum, and so does the greedy's partition."""
    from repro_torch.core.cache_controller import lookahead_traced

    rng = np.random.default_rng(seed)
    n, U = 4, 256
    hist = np.zeros((n, U + 1))
    for _ in range(halvings + 1):
        hist *= 0.5
        hist += rng.poisson(rng.uniform(0.2, 30.0, (n, 1)) * np.exp(
            -np.arange(U + 1) / rng.uniform(2.0, 80.0, (n, 1))))
    h32 = torch.as_tensor(hist, dtype=torch.float32)
    assert np.array_equal(h32.double().numpy(), hist)
    curve32 = torch.cat([torch.zeros((n, 1)),
                         torch.cumsum(h32[:, :U], dim=-1)], dim=-1)
    curve64 = np.concatenate([np.zeros((n, 1)),
                              np.cumsum(hist[:, :U], axis=-1)], axis=-1)
    np.testing.assert_array_equal(curve32.double().numpy(), curve64)
    got = lookahead_traced(curve32.double()[None],
                           torch.tensor([2], dtype=torch.int32), U)[0]
    want = cache_controller_numpy.lookahead_allocate(curve64, U, 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ #
# in-place decode
# ------------------------------------------------------------------ #

INPLACE_CASES = {
    "dense": ("qwen3-8b", {}),
    "int8": ("qwen3-8b", {"kv_cache_dtype": "int8"}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("zamba2-7b", {}),
    "encdec": ("whisper-tiny", {}),
    "dus": ("qwen3-8b", {"decode_cache_update": "dus"}),
}


@pytest.mark.parametrize("positions", ["per_row", "scalar"])
@pytest.mark.parametrize("case", list(INPLACE_CASES))
def test_inplace_decode_is_bit_identical(case, positions):
    arch, overrides = INPLACE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke(arch), **overrides)
    model = build(cfg, device="cpu", seed=0)
    B, max_len = 3, 16
    out_of_place = model.init_cache(B, max_len, dtype=torch.float32)
    inplace = model.init_cache(B, max_len, dtype=torch.float32)
    buffers = {k: v.data_ptr() for k, v in inplace.items()}
    rng = np.random.default_rng(0)
    start = np.array([0, 3, 9])      # row 2 runs past the cache
    for t in range(12):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)))
        cur = (torch.as_tensor(start + t, dtype=torch.int32)
               if positions == "per_row" else t + 6)
        want, out_of_place = model.decode_step(out_of_place, tokens, cur)
        got, same = model.decode_step(inplace, tokens, cur, inplace=True)
        assert same is inplace
        assert torch.equal(got, want), t
    assert {k: v.data_ptr() for k, v in inplace.items()} == buffers
    for key, value in out_of_place.items():
        assert torch.equal(inplace[key], value), key


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #

#: The launcher under ``use_devices``, the port's counterpart of the
#: reference's forced host devices: ``--groups`` shards over the list.
FORCED_LAUNCH = """
import sys, torch
from repro_torch.distributed import use_devices
from repro_torch.launch.serve import main
with use_devices([torch.device("cpu")] * 2):
    main(sys.argv[1:])
"""


@pytest.mark.parametrize("engine,groups", [
    ("host", 1), ("graph", 1), ("graph", 2)],
    ids=["host", "graph", "graph-groups2-on-2-devices"])
def test_launcher_serves_on_the_cpu(engine, groups):
    entry = (["-m", "repro_torch.launch.serve"] if groups == 1 else
             ["-c", FORCED_LAUNCH, "--streams", "4", "--groups", "2"])
    proc = subprocess.run(
        [sys.executable, *entry, "--device", "cpu",
         "--engine", engine, "--requests", "6", "--max-new", "4"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"}, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"engine={engine}" in proc.stdout
    assert "completed 6/6" in proc.stdout
    if groups == 2:
        assert "grid K=1 M=2 a=1 b=2: groups [[0], [1]] on cpu, cpu" \
            in proc.stdout
