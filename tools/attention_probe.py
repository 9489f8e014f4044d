#!/usr/bin/env python3
"""Probe what bounds the ``flash_attention`` CUDA kernel on the card, and
how far each of its accuracy measures is needed.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/attention_probe.py

It builds variants of ``src/repro_torch/csrc/flash_attention.cu``, each
the source with a few lines replaced, into ``build/probe_attn/`` (one
``nvcc`` each, all at once), loads them with ``ctypes`` and, in one
process on one card, runs each at the qwen3-8b prefill shape (1 x 32 x
4096 x 128, causal, k/v repeated from 8 heads; bf16, and float32 drawn
in float32) with ``block_q = block_kv = 128``:

* times, beside ``scaled_dot_product_attention``:

  - ``as_is``: the kernel;
  - ``no_softmax``: without the online softmax (S goes to the P V
    product as it is): the loads, products and barriers alone;
  - ``products_only``: without the loads (the producer marks each stage
    full at once): the products, softmax and barriers alone;
  - ``loads_only``: without the products: the feed, softmax and
    barriers alone;

* counts the outputs beyond the limits of
  ``repro_torch.kernels.tolerance`` from the plain version, for the
  kernel and for:

  - ``p_once`` (bf16): P rounded once to bf16, without its low part;
  - ``one_tf32`` (f32): one TF32 product in each of S and P V, without
    the hi / lo terms;
  - ``one_accumulator`` (f32): P V summed straight into O, without each
    stage's own accumulator;
  - ``scaled_dot_product_attention`` in the same dtype (TF32 off).

Every line is JSON with the card's name and power limit.  The variants
are probes, not kernels of the port: the timings of the other variants
carry wrong results on purpose.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "probe_attn"

_SOFTMAX = re.compile(r"softmax_stage<kN>\([^;]*\);")
_PV_BF16 = ("            hopper::wgmma_bf16_rs<kD>(o, al, dv);\n"
            "            hopper::wgmma_bf16_rs<kD>(o, ah, dv);\n")
#: (old, new) replacements; an old string is a regular expression when it
#: is compiled.
VARIANTS = {
    "as_is": [],
    "no_softmax": [(_SOFTMAX, "alpha[0] = alpha[1] = 1.f;")],
    "products_only": [
        ("        hopper::mbar_arrive_expect_tx(qfull, L::kQ);\n",
         "        hopper::mbar_arrive(qfull);\n"),
        ("        for (int ch = 0; ch < L::kChunks; ++ch)\n"
         "          hopper::tma_load_3d(sq",
         "        for (int ch = 0; ch < 0; ++ch)\n"
         "          hopper::tma_load_3d(sq"),
        ("          hopper::mbar_arrive_expect_tx(&full[s], L::kStage);\n",
         "          hopper::mbar_arrive(&full[s]);\n"),
        ("          for (int ch = 0; ch < L::kChunks; ++ch) {\n",
         "          for (int ch = 0; ch < 0; ++ch) {\n")],
    "loads_only": [
        ("            hopper::wgmma_bf16_kmajor<kN>(sc, dq, dk);\n", ""),
        (_PV_BF16, ""),
        ("          hopper::wgmma_tf32<kN>(sc, ql, kh);\n"
         "          hopper::wgmma_tf32<kN>(sc, qh, kl);\n"
         "          hopper::wgmma_tf32<kN>(sc, qh, kh);\n", ""),
        ("          hopper::wgmma_tf32_rs<kD>(part, al, vh);\n"
         "          hopper::wgmma_tf32_rs<kD>(part, ah, vl);\n"
         "          hopper::wgmma_tf32_rs<kD>(part, ah, vh);\n", "")],
    "p_once": [(_PV_BF16,
                "            hopper::wgmma_bf16_rs<kD>(o, ah, dv);\n")],
    "one_tf32": [
        ("          hopper::wgmma_tf32<kN>(sc, ql, kh);\n"
         "          hopper::wgmma_tf32<kN>(sc, qh, kl);\n", ""),
        ("          hopper::wgmma_tf32_rs<kD>(part, al, vh);\n"
         "          hopper::wgmma_tf32_rs<kD>(part, ah, vl);\n", "")],
    "one_accumulator": [
        ("        for (int e = 0; e < kD / 2; ++e) part[e] = 0.f;\n",
         "        for (int e = 0; e < kD / 2; ++e)"
         " o[e] *= alpha[(e / 2) % 2];\n"),
        ("hopper::wgmma_tf32_rs<kD>(part,", "hopper::wgmma_tf32_rs<kD>(o,"),
        ("          o[e] = o[e] * alpha[(e / 2) % 2] + part[e];\n",
         "          (void)part[e];\n")],
}
TIMED = ("as_is", "no_softmax", "products_only", "loads_only")
ACCURACY = {"bfloat16": ("as_is", "p_once"),
            "float32": ("as_is", "one_tf32", "one_accumulator")}


def variant_source(text: str, subs) -> str:
    """``text`` with every replacement of ``subs`` made; raises if one of
    them no longer matches."""
    for old, new in subs:
        if isinstance(old, re.Pattern):
            text, hits = old.subn(new, text)
        else:
            hits = text.count(old)
            text = text.replace(old, new)
        if not hits:
            raise SystemExit(f"the source no longer holds {old!r}")
    return text


def build_variants(nvcc: str, flags) -> dict:
    """{name: launch function} of every variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        path = OUT / f"{name}.cu"
        path.write_text(variant_source(text, subs))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(SRC.parent), "-o",
             str(OUT / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        launch = ctypes.CDLL(str(OUT / f"lib{name}.so")).flash_attention_launch
        launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        launch.restype = ctypes.c_int
        fns[name] = launch
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.tolerance import limits

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = build_variants(build.nvcc_path(), build.NVCC_FLAGS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    B, H, S, D, HKV = 1, 32, 4096, 128, 8

    def run(name, q, k, v, out):
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B * H, S, S, D, 128, 128, 1, D ** -0.5,
                build.DTYPE_CODES[q.dtype])

        def call():
            err = fns[name](*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def emit(**fields):
        print(json.dumps({**fields, "card": card}), flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        def r(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = r(B, H, S, D)
        k, v = (r(B, HKV, S, D).repeat_interleave(H // HKV, dim=1)
                .contiguous() for _ in range(2))
        out = torch.empty_like(q)
        name = str(dtype).split(".")[-1]
        emit(probe="time", dtype=name, shape=[B, H, S, D], causal=True,
             knobs=[128, 128],
             sdpa_ms=ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True)),
             **{f"{n}_ms": ms(run(n, q, k, v, out)) for n in TIMED})
        want = flash_attention_plain(q, k, v, causal=True)
        atol, rtol = limits("flash_attention", want)
        w = want.float()

        def beyond(x):
            x = x.float()
            return (int((~torch.isclose(x, w, atol=atol, rtol=rtol)).sum()),
                    float((x - w).abs().max()))

        counts = {}
        for n in ACCURACY[name]:
            run(n, q, k, v, out)()
            torch.cuda.synchronize()
            counts[n] = beyond(out)
        counts["sdpa"] = beyond(F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        emit(probe="accuracy", dtype=name, shape=[B, H, S, D],
             outputs=q.numel(), atol=atol, rtol=rtol,
             beyond_limit_and_max_abs_err=counts)
        del q, k, v, out, want, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
