"""The serving engine's groups sharded over blocks forced onto the card
(``use_devices([cuda:0] * N)``), against the unsharded card run and the
port's CPU sharded run.

The reference's sharded-engine fixture (``tests/_torch_serving_ref.py``:
``parity_config``, ``parity_requests``) with the qwen3-8b smoke model,
float32, built from a seed on the CPU and copied to the card, TF32 off:

* on 2 and 8 blocks, against the unsharded card engine and the CPU
  sharded run: tokens equal under the token rule (the card host engine's
  margins), every other discrete output exactly, slot shares and queue
  waits within rtol 1e-6 (``chip_smoke.SERVE_SHARE_RTOL``).  Not bit for
  bit: a block decodes a smaller batch, for which cuBLAS may choose
  another kernel.  One interval replay a block an interval; one
  reconfiguration replay and one greedy launch a reconfiguration a block
  runs, plus one a block in the warm-up before its capture;
* with two cards or more, one block a card, on replicas past the first;
* a warm second run replays without a new capture in any block;
* a capture that fails in one block raises.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_serving_shards_cuda.py``.  The file imports neither JAX
nor the JAX package.
"""
import copy

import numpy as np
import pytest
import torch

from _torch_serving_ref import (
    parity_config,
    parity_requests,
    record_margins,
    token_rule,
    top2_torch,
)

from repro_torch import configs, distributed
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.models import build
from repro_torch.serving import (
    EngineConfig,
    GraphServingEngine,
    Request,
    ServingEngine,
)

pytestmark = pytest.mark.cuda

SHARE_RTOL = 1e-6
MAX_STEPS = 300
STREAMS = 8
DISCRETE = ("steps", "reconfigs", "intervals", "partition", "readahead",
            "occupancy", "evictions", "tokens_done", "demand_hits",
            "demand_misses", "prefetch_hits", "prefetch_misses")


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: sharded serving on the card is "
                    "held to the unsharded card run")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build(configs.get_smoke("qwen3-8b"), device="cpu", seed=0)
    yield cpu, copy.deepcopy(cpu).to("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def requests(model):
    return parity_requests(Request, model.cfg.vocab_size, STREAMS)


def engine(model, n_blocks):
    dev = model.device
    with distributed.use_devices([dev] * n_blocks):
        return GraphServingEngine(model, STREAMS, parity_config(EngineConfig),
                                  n_groups=STREAMS, device=dev.type)


def run(eng):
    reqs = requests(eng.model)
    reset_launch_counts()
    eng.run(reqs, max_steps=MAX_STEPS)
    return reqs, launch_counts()


@pytest.fixture(scope="module")
def margins(models):
    """The card host engine's top-2 margins on the fixture."""
    _, card = models
    host = ServingEngine(card, STREAMS, parity_config(EngineConfig),
                         device="cuda")
    out = record_margins(host, top2_torch)
    host.run(requests(card), max_steps=MAX_STEPS)
    return out


@pytest.fixture(scope="module")
def unsharded(models):
    _, card = models
    eng = engine(card, 1)
    return eng, run(eng)[0]


def hold(eng, reqs, want, want_reqs, margins):
    verdicts = [token_rule(r.generated, w.generated, margins.get(w.rid, []))
                for r, w in zip(reqs, want_reqs)]
    assert "differ" not in verdicts, verdicts
    for key in DISCRETE:
        np.testing.assert_array_equal(getattr(eng, key), getattr(want, key),
                                      err_msg=key)
    for key in ("slot_share", "queue_wait"):
        np.testing.assert_allclose(getattr(eng, key), getattr(want, key),
                                   rtol=SHARE_RTOL, atol=0, err_msg=key)


def launch_rule(eng, counts, captured: bool):
    blocks = len(eng.block_groups)
    warmups = sum(k.endswith("reconfigure_warmup")
                  for k in eng.capture_seconds)
    assert warmups == (blocks if captured else 0)
    assert counts["serve_graph"] == eng.intervals * blocks
    assert counts["serve_reconfig"] == sum(eng.block_reconfigs)
    assert counts["lookahead_greedy"] == sum(eng.block_reconfigs) + warmups


@pytest.mark.parametrize("n_blocks", [2, 8])
def test_sharded_on_the_card(models, margins, unsharded, n_blocks):
    cpu, card = models
    eng = engine(card, n_blocks)
    reqs, counts = run(eng)
    assert len(eng.block_groups) == n_blocks
    launch_rule(eng, counts, captured=True)
    hold(eng, reqs, *unsharded, margins)
    on_cpu = engine(cpu, n_blocks)
    hold(eng, reqs, on_cpu, run(on_cpu)[0], margins)


def test_sharded_over_every_card(models, margins, unsharded):
    """With two cards or more, one block a card (blocks past cuda:0 on
    replicas of the model, each captured and replayed on its own card),
    held to the unsharded run on cuda:0."""
    _, card = models
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two NVIDIA cards or more")
    devices = [torch.device("cuda", i) for i in range(n)]
    with distributed.use_devices(devices):
        eng = GraphServingEngine(card, STREAMS, parity_config(EngineConfig),
                                 n_groups=STREAMS, device="cuda")
    reqs, counts = run(eng)
    blocks = len(eng.block_groups)
    assert blocks > 1 and eng.devices == devices[:blocks]
    for b, run_ in enumerate(eng._runs.values()):
        assert run_.model.device == devices[b]
        assert (run_.model is card) == (b == 0)
        assert run_.steps.device == devices[b]
    launch_rule(eng, counts, captured=True)
    hold(eng, reqs, *unsharded, margins)


def test_warm_sharded_run_replays_without_capture(models, unsharded,
                                                  margins):
    _, card = models
    eng = engine(card, 2)
    cold, _ = run(eng)
    assert set(eng.capture_seconds) == {
        f"block{b}/{which}_{k}" for b in (0, 1)
        for which in ("steps", "reconfigure") for k in ("warmup", "capture")}
    warm, counts = run(eng)
    assert eng.capture_seconds == {}
    launch_rule(eng, counts, captured=False)
    assert [r.generated for r in warm] == [r.generated for r in cold]
    hold(eng, warm, *unsharded, margins)


def test_a_failed_capture_in_one_block_raises(models, monkeypatch):
    """A host read inside block 1's interval program fails its capture;
    the engine raises instead of running that block eagerly or
    elsewhere."""
    _, card = models
    eng = engine(card, 2)
    real = eng._one_step

    def reads_the_host_in_block_1(run):
        real(run)
        if run.block == 1:
            bool(run.q["active"].any())

    monkeypatch.setattr(eng, "_one_step", reads_the_host_in_block_1)
    with pytest.raises(RuntimeError):
        eng.run(requests(card), max_steps=MAX_STEPS)
    assert eng._runs[next(iter(eng._runs))].steps is not None
