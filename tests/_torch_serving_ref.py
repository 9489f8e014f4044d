"""Reference runs of the JAX package's serving engines for the port's
serving tests (``tests/test_torch_serving.py``), and what the tests and
``chip_smoke.py`` phases 15 and 17 share: the fixtures (the sharded
engine's parity fixture among them), the margin recorder and the token
rule.  Importing this module imports neither JAX nor the JAX
package; only the subprocess does.

The reference runs in one subprocess with x64 OFF, as
``tests/test_serving_jax.py`` runs it: its ``ServingEngine`` and
``JitServingEngine`` on ``configs.get_smoke("qwen3-8b")`` with
``Model.init(jax.random.PRNGKey(0))`` parameters, over every fixture of
:func:`fixtures`.  It writes the parameters (``.npz``) and every engine's
outputs (``.json``); the jitted engine's hit/miss counts come from its
final state, read by a subclass that keeps it (no file of the reference
changes).

Run as a script: ``python tests/_torch_serving_ref.py OUT_PREFIX``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "qwen3-8b"
MAX_STEPS = 300

#: The token rule's bound on the reference's own top-2 logit gap at the
#: first step a request's tokens differ: the model tests' tolerance
#: (``tests/test_torch_models.py``: rtol 1e-4, atol 1e-5).
GAP_ATOL, GAP_RTOL = 1e-5, 1e-4


# ------------------------------------------------------------------ #
# fixtures: tests/test_serving_jax.py's, unchanged
# ------------------------------------------------------------------ #

def requests_main(Request, vocab, n=14, n_streams=4, seed=3, max_prompt=6,
                  max_new=7):
    """``tests/test_serving_jax.py::_requests`` (l.52-64)."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            stream=int(rng.integers(n_streams)),
            prompt=rng.integers(
                1, vocab, size=int(rng.integers(1, max_prompt + 1))
            ).astype(np.int32),
            max_new_tokens=int(rng.integers(1, max_new + 1)),
        )
        for _ in range(n)
    ]


def requests_staggered(Request, vocab):
    """The staggered-admission requests (l.132-141, seed 11)."""
    rng = np.random.default_rng(11)
    return [Request(stream=i % 3,
                    prompt=rng.integers(1, vocab, size=3 + 4 * (i % 3)
                                        ).astype(np.int32),
                    max_new_tokens=5)
            for i in range(8)]


def requests_queue_wait(Request, vocab):
    """One slot, two same-stream requests (l.167-172)."""
    prompt = np.asarray([3], dtype=np.int32)
    return [Request(0, prompt.copy(), max_new_tokens=3),
            Request(0, prompt.copy(), max_new_tokens=2)]


def requests_tie_break(Request, vocab):
    """Equal deficits, stream 1 enqueued first (l.186-196)."""
    prompts = [np.asarray([5 + i], dtype=np.int32) for i in range(4)]
    return [Request(1, prompts[0], max_new_tokens=1),
            Request(0, prompts[1], max_new_tokens=1),
            Request(1, prompts[2], max_new_tokens=1),
            Request(0, prompts[3], max_new_tokens=1)]


def fixtures(EngineConfig):
    """{name: (n_streams, EngineConfig, requests(Request, vocab),
    n_groups of the device engine)}: ``ECFG`` (l.66-67) at one and two
    groups, the staggered admissions, the one-slot queue-wait and
    tie-break configs (l.164-165, l.183-184), and CBP off (l.116-117)."""
    ecfg = EngineConfig(batch_slots=4, max_len=48, page_tokens=4,
                        total_pages=24, reconfig_every_steps=8)
    one = EngineConfig(batch_slots=1, max_len=48, page_tokens=4,
                       total_pages=24, reconfig_every_steps=10**6,
                       min_slot_share=0.25)
    off = EngineConfig(batch_slots=4, max_len=48, page_tokens=4,
                       total_pages=24, reconfig_every_steps=10**9)
    return {
        "main": (4, ecfg, requests_main, (1, 2)),
        "staggered": (3, ecfg, requests_staggered, (1,)),
        "queue_wait": (1, one, requests_queue_wait, (1,)),
        "tie_break": (2, one, requests_tie_break, (1,)),
        "cbp_off": (4, off, requests_main, (1,)),
    }


def parity_config(EngineConfig):
    """The engine configuration of ``tests/test_serving_jax.py``'s
    ``_PARITY_SCRIPT`` (l.236-273), the reference's sharded-engine gate."""
    return EngineConfig(batch_slots=16, max_len=48, page_tokens=4,
                        total_pages=64, reconfig_every_steps=8)


def parity_requests(Request, vocab, n_streams=8):
    """``_PARITY_SCRIPT``'s 40 requests (seed 7) over ``n_streams``
    streams (the script's 8; 16 for sixteen one-stream groups)."""
    rng = np.random.default_rng(7)
    return [Request(stream=int(rng.integers(n_streams)),
                    prompt=rng.integers(1, vocab,
                                        size=int(rng.integers(1, 7))
                                        ).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 8)))
            for _ in range(40)]


# ------------------------------------------------------------------ #
# margins and the token rule
# ------------------------------------------------------------------ #

def top2_numpy(logits) -> np.ndarray:
    """Each row's two largest last-position logits, largest first."""
    last = np.asarray(logits, dtype=np.float64)[:, -1, :]
    return np.sort(last, axis=-1)[:, :-3:-1]


def top2_torch(logits) -> np.ndarray:
    """:func:`top2_numpy` of a tensor, on its device."""
    import torch

    return torch.topk(logits[:, -1, :].to(torch.float64), 2,
                      dim=-1).values.cpu().numpy()


def record_margins(engine, top2) -> dict:
    """Wrap a host engine's ``_decode`` and ``_touch_pages`` so that every
    generated token of a request gets the (top-2 gap, top logit) of its
    slot's logits at that step; returns ``{rid: [(gap, top), ...]}``,
    filled as the engine runs.  ``top2`` is :func:`top2_numpy` or
    :func:`top2_torch`."""
    margins: dict = {}
    step = {}
    # The engine is held weakly: the spies live on it, so a strong
    # reference would make a cycle that keeps its KV cache after a drop.
    decode, touch = engine._decode, engine._touch_pages.__func__
    engine_ref = weakref.ref(engine)

    def spy_decode(*args):
        logits, cache = decode(*args)
        step["top2"] = top2(logits)
        return logits, cache

    def spy_touch(req, pos):
        if pos + 1 >= len(req.prompt):
            first, second = step["top2"][req.slot]
            margins.setdefault(req.rid, []).append(
                (float(first - second), float(first)))
        return touch(engine_ref(), req, pos)

    engine._decode, engine._touch_pages = spy_decode, spy_touch
    return margins


def token_rule(got, want, margins) -> str:
    """"equal", "excused" (the tokens agree up to a step where the
    reference's top-2 gap is at most ``GAP_ATOL + GAP_RTOL * |top|``; not
    compared from there on) or "differ"."""
    if list(got) == list(want):
        return "equal"
    n = min(len(got), len(want))
    first = next((i for i in range(n) if got[i] != want[i]), n)
    if len(got) == len(want) and first < len(margins):
        gap, top = margins[first]
        if gap <= GAP_ATOL + GAP_RTOL * abs(top):
            return "excused"
    return "differ"


# ------------------------------------------------------------------ #
# the reference, in a subprocess
# ------------------------------------------------------------------ #

def serving_reference(tmp_path_factory) -> dict:
    """Run the reference over every fixture in one x64-off subprocess;
    returns ``{"params": tree, "runs": {name: {...}}}``."""
    from _torch_model_ref import unflatten

    out = tmp_path_factory.mktemp("jax_serving_ref") / "serving"
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")])})
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX serving reference failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    with np.load(f"{out}.npz") as data:
        params = unflatten(dict(data))
    return {"params": params,
            "runs": json.loads(Path(f"{out}.json").read_text())}


def _host_outputs(eng, reqs, margins) -> dict:
    return {
        "tokens": [r.generated for r in reqs],
        "margins": [margins.get(r.rid, []) for r in reqs],
        "steps": eng.steps, "reconfigs": eng.reconfigs,
        "queue_wait": np.asarray(eng.queue_wait).tolist(),
        "slot_share": np.asarray(eng.slot_share).tolist(),
        "tokens_done": np.asarray(eng.tokens_done).tolist(),
        "readahead": np.asarray(eng.readahead).tolist(),
        "partition": np.asarray(eng.pool.partition).tolist(),
        "occupancy": np.asarray(eng.pool.occupancy()).tolist(),
        "stats": [[s.hits, s.misses, s.evictions, s.prefetch_hits,
                   s.prefetch_misses] for s in eng.pool.stats],
    }


def _jit_outputs(eng, reqs, dispatches) -> dict:
    q = eng.final_q
    return {
        "tokens": [r.generated for r in reqs],
        "steps": eng.steps, "reconfigs": eng.reconfigs,
        "intervals": eng.intervals, "dispatches": dispatches,
        **{k: np.asarray(getattr(eng, k)).tolist() for k in (
            "queue_wait", "slot_share", "tokens_done", "readahead",
            "partition", "occupancy", "evictions")},
        **{k: q[k].reshape(-1).tolist() for k in (
            "demand_hits", "demand_misses", "prefetch_hits",
            "prefetch_misses")},
    }


def _run(prefix: str) -> None:
    import jax

    assert not jax.config.jax_enable_x64
    from _torch_model_ref import flatten

    from repro import configs
    from repro.core.dispatch import (device_dispatches,
                                     reset_device_dispatches)
    from repro.models.model import Model
    from repro.serving import (EngineConfig, JitServingEngine, Request,
                               ServingEngine)

    class KeptState(JitServingEngine):
        """The jitted engine, keeping its final queue state."""

        def _finalize(self, state, requests):
            self.final_q = {k: np.asarray(v) for k, v in state["q"].items()}
            super()._finalize(state, requests)

    cfg = configs.get_smoke(ARCH)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    runs = {}
    for name, (n, ecfg, make, groups) in fixtures(EngineConfig).items():
        host = ServingEngine(model, params, n_streams=n, cfg=ecfg)
        margins = record_margins(host, top2_numpy)
        reqs = make(Request, cfg.vocab_size)
        host.run(reqs, max_steps=MAX_STEPS)
        runs[f"{name}/host"] = _host_outputs(host, reqs, margins)
        for g in groups:
            eng = KeptState(model, params, n_streams=n, cfg=ecfg,
                            n_groups=g)
            reqs = make(Request, cfg.vocab_size)
            reset_device_dispatches()
            eng.run(reqs, max_steps=MAX_STEPS)
            runs[f"{name}/jit{g}"] = _jit_outputs(eng, reqs,
                                                  device_dispatches())
    np.savez(f"{prefix}.npz", **flatten(jax.tree.map(np.asarray, params)))
    Path(f"{prefix}.json").write_text(json.dumps(runs))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    _run(sys.argv[1])
