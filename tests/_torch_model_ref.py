"""Reference values from the JAX package's models for the port's model
tests (``tests/test_torch_models.py``).

The JAX models are held in float32 with x64 OFF, as the JAX package's own
model tests run them (``tests/test_models_smoke.py``,
``tests/test_decode_parity.py``): under ``JAX_ENABLE_X64=1`` positions and
unannotated arrays become 64-bit and the reference is another program.  So
the cases run in subprocesses of their own (not ``_torch_jax_ref.py``'s
x64 one), with ``loss``, ``prefill`` and ``decode_step`` jitted.  Inputs
are drawn from numpy seeds here (:func:`model_inputs`), parameters by the
reference's ``Model.init(jax.random.PRNGKey(0))``; the subprocesses (three,
side by side: :data:`GROUPS`) write parameters and outputs to ``.npz``
files, and the test feeds the same parameters to the port through
``params_from_jax``.  Each output comes with the reference's own spread:
its distance to the same output with every parameter one ulp up.

Run as a script: ``python tests/_torch_model_ref.py OUT.npz CASE...``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"

ARCHS = ("whisper-tiny", "pixtral-12b", "qwen3-8b", "yi-9b", "yi-34b",
         "minitron-8b", "qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-1.3b",
         "zamba2-7b")

B, S = 2, 32     # loss and prefill batch (tests/test_models_smoke.py)
T = 12           # decode steps (tests/test_decode_parity.py)
MAX_LEN = T + 4  # decode cache length; whisper's encoder length too

#: case -> (arch, config overrides).  ``attn_chunk=T`` is the decode-parity
#: test's; with S = 32 the chunked attention ends in a remainder chunk.
#: MoE cases take ``capacity_factor=8.0`` (drop-free, as the parity test);
#: "moe_overflow" keeps the smoke capacity (C = 20 at B x S = 64 tokens)
#: with parameters whose first layer overflows an expert (ROADMAP R3).
CASES = {arch: (arch, {"attn_chunk": T}) for arch in ARCHS}
for _arch in ("qwen3-moe-30b-a3b", "grok-1-314b"):
    CASES[_arch][1]["capacity_factor"] = 8.0
CASES["int8"] = ("qwen3-8b", {"attn_chunk": T, "kv_cache_dtype": "int8"})
CASES["moe_overflow"] = ("qwen3-moe-30b-a3b", {"attn_chunk": T})

#: What the reference computes for each case: "int8" only decodes (its
#: loss and prefill are "qwen3-8b"'s), "moe_overflow" adds the standalone
#: MoE layer in place of decode (a decode step's 2 tokens overflow at the
#: smoke capacity too, but the loss batch shows R3 at the table's size).
OUTPUTS = {case: ("loss", "prefill", "decode") for case in CASES}
OUTPUTS["int8"] = ("decode",)
OUTPUTS["moe_overflow"] = ("loss", "prefill", "moe")

#: The subprocesses and their cases, about equal in compile time.  The
#: smoke configs of yi-9b, yi-34b and minitron-8b differ in name alone, so
#: their one reference is computed once (name is not read by the models).
GROUPS = (("whisper-tiny", "pixtral-12b", "qwen3-8b", "int8", "yi-9b",
           "yi-34b", "minitron-8b"),
          ("qwen3-moe-30b-a3b", "grok-1-314b", "moe_overflow"),
          ("mamba2-1.3b", "zamba2-7b"))

#: The parameter key of each case (``jax.random.PRNGKey``): 0, as the
#: JAX package's tests, but for "moe_overflow", whose key gives an expert
#: of the first layer more than its capacity on the loss batch.
PARAM_KEY = {case: 0 for case in CASES}
PARAM_KEY["moe_overflow"] = 1


def case_config(configs, case: str):
    """The case's config from ``configs`` (``repro.configs`` or
    ``repro_torch.configs``)."""
    arch, overrides = CASES[case]
    return dataclasses.replace(configs.get_smoke(arch), **overrides)


def model_inputs(cfg, seed: int = 0) -> dict:
    """The loss/prefill batch (B, S) and the decode inputs (B, T), drawn
    with numpy; labels are the next tokens, the last masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.frontend in ("audio", "patch") and cfg.family != "encdec":
        batch = {"embeddings": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32), "labels": labels}
    # decode feeds the batch's first T tokens (or embeddings) one by one
    steps = batch.get("embeddings", toks)[:, :T]
    return {"batch": batch, "steps": steps}


def moe_input(cfg, seed: int = 3) -> np.ndarray:
    """The "moe_overflow" case's standalone MoE input (B, S, d)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def model_reference(tmp_path_factory) -> dict:
    """Run every case in x64-off JAX subprocesses, one per group of
    :data:`GROUPS`, side by side; return ``{case: {"params": tree,
    "loss": ..., "prefill": ..., "decode": ...}}`` (what :data:`OUTPUTS`
    names; "moe_overflow" adds the MoE spy's captures under "moe")."""
    tmp = tmp_path_factory.mktemp("jax_model_ref")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")])})
    runs = []
    for i, group in enumerate(GROUPS):
        out = tmp / f"models{i}.npz"
        runs.append((out, subprocess.Popen(
            [sys.executable, __file__, str(out), *group], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    flat = {}
    for out, proc in runs:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX model reference failed:\n{stdout}\n"
                               f"{stderr}")
        with np.load(out) as data:
            flat.update(data)
    cases: dict = {}
    for path, value in flat.items():
        case, rest = path.split("/", 1)
        cases.setdefault(case, {})[rest] = value
    return {case: unflatten(values) for case, values in cases.items()}


# ------------------------------------------------------------------ #
# the subprocess (x64 off)
# ------------------------------------------------------------------ #


def _decode(step, jnp, params, cache, steps):
    """Decode logits (B, T, V) of ``steps`` fed one by one, and the cache."""
    outs = []
    for i in range(steps.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(steps[:, i:i + 1]),
                             jnp.asarray(i, jnp.int32))
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1), cache


def _cross_cache(jax, jnp, cfg, params, cache, frames):
    """Cross K/V from the encoder, as ``test_models_smoke.py`` fills them."""
    from repro.models import encdec
    hidden = encdec.encode(params, cfg, jnp.asarray(frames))
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[li], params["decoder"])
        shape = (B, frames.shape[1], cfg.n_kv_heads, cfg.head_dim)
        ks.append(jnp.einsum("bsd,dk->bsk", hidden,
                             lp["xattn"]["wk"]).reshape(shape))
        vs.append(jnp.einsum("bsd,dk->bsk", hidden,
                             lp["xattn"]["wv"]).reshape(shape))
    cache = dict(cache)
    cache["xk"] = jnp.stack(ks).astype(cache["xk"].dtype)
    cache["xv"] = jnp.stack(vs).astype(cache["xv"].dtype)
    cache["enc_len"] = jnp.asarray(frames.shape[1], jnp.int32)
    return cache


def _moe_spy(jax, transformer, lp, cfg, x):
    """``moe_ffn`` run un-jitted with ``lax.top_k`` and the dispatch
    scatter's ``vmap`` recorded: its output, the top-k experts and the
    kept-slot table (G, E, C)."""
    seen = {}
    top_k, vmap = jax.lax.top_k, jax.vmap

    def spy_top_k(operand, k):
        gates, experts = top_k(operand, k)
        seen["experts"] = np.asarray(experts)
        return gates, experts

    def spy_vmap(fn, *args, **kw):
        mapped = vmap(fn, *args, **kw)
        if getattr(fn, "__name__", "") != "scatter_idx":
            return mapped

        def run(*xs):
            out = mapped(*xs)
            seen["slots"] = np.asarray(out)
            return out
        return run

    jax.lax.top_k, jax.vmap = spy_top_k, spy_vmap
    try:
        y = transformer.moe_ffn(lp, cfg, x)
    finally:
        jax.lax.top_k, jax.vmap = top_k, vmap
    return {"y": np.asarray(y), **seen}


def _run(path: str, cases) -> None:
    import jax
    import jax.numpy as jnp

    assert not jax.config.jax_enable_x64
    from repro import configs
    from repro.models import build, transformer

    arrays, done = {}, {}
    for case in cases:
        cfg = case_config(configs, case)
        key = (dataclasses.replace(cfg, name=""), PARAM_KEY[case],
               OUTPUTS[case])
        if key not in done:
            done[key] = _outputs(jax, jnp, build, transformer, cfg, case)
        arrays.update({f"{case}/{k}": v for k, v in done[key].items()})
    np.savez(path, **arrays)


def _outputs(jax, jnp, build, transformer, cfg, case) -> dict:
    """The case's outputs, each also under ``spread/`` as its largest
    distance to the same output with every float parameter one ulp up:
    the reference's own rounding-level spread."""
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(PARAM_KEY[case]))
    nudged = jax.tree.map(
        lambda a: jnp.nextafter(a, jnp.inf)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, params)
    inp = model_inputs(cfg)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    want = OUTPUTS[case]
    res, spread = {}, {}
    if "loss" in want:   # one program for both: one compile
        run = jax.jit(lambda p, b: (model.loss(p, b), model.prefill(p, b)))
        (res["loss"], res["prefill"]), (l1, p1) = (run(params, batch),
                                                  run(nudged, batch))
        spread["loss"], spread["prefill"] = (
            jnp.abs(l1 - res["loss"]), jnp.abs(p1 - res["prefill"]).max())
    if "decode" in want:
        step = jax.jit(model.decode_step)
        outs = []
        for p in (params, nudged):
            cache = model.init_cache(B, MAX_LEN, dtype=jnp.float32)
            if cfg.family == "encdec":
                cache = _cross_cache(jax, jnp, cfg, p, cache,
                                     inp["batch"]["frames"][:, :MAX_LEN])
            outs.append(_decode(step, jnp, p, cache, inp["steps"]))
        (res["decode"], cache), (d1, _) = outs
        spread["decode"] = np.abs(d1 - res["decode"]).max()
        if cfg.kv_cache_dtype == "int8":
            res["cache_k"], res["cache_v"] = cache["k"], cache["v"]
    if "moe" in want:
        lp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        res.update({f"moe/{k}": v for k, v in _moe_spy(
            jax, transformer, lp, cfg, jnp.asarray(moe_input(cfg))).items()})
    res.update({f"spread/{k}": v for k, v in spread.items()})
    res = {k: np.asarray(v) for k, v in res.items()}
    res.update({f"params/{k}": v for k, v in flatten(params).items()})
    return res


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2:])
