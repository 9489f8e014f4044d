#!/usr/bin/env python3
"""Probe what bounds the ``ssd_scan`` CUDA kernel on the card, and how far
each of its accuracy measures is needed.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/ssd_probe.py

It builds variants of ``src/repro_torch/csrc/ssd_scan.cu``, each the
source with a few lines replaced, into ``build/probe_ssd/`` (one ``nvcc``
each, all at once), loads them with ``ctypes`` and, in one process on one
card, runs each at mamba2-1.3b's full width (2 x 4096 steps, 64 heads,
P = 64, N = 128, chunk 128; float32 and bfloat16, inputs drawn as
``chip_smoke.py`` draws them):

* times:

  - ``as_is``: the kernel;
  - ``no_loads``: without its loads (the producer marks each stage or
    box full at once, no TMA and no copy): products, splits and barriers;
  - ``no_products``: without any ``wgmma``: the feed, the splits, the
    decay and the barriers;
  - ``no_state_chain``: warpgroup 0 never waits for the state of a chunk
    and warpgroup 1 never waits for warpgroup 0 to be done with it: the
    chain of chunks taken away;

* counts the outputs beyond the limits of ``repro_torch.kernels.tolerance``
  from the plain version (the sequential recurrence), for the kernel and
  for:

  - ``one_pass``: every product once, on the bf16 high parts alone (in
    float32 the inputs rounded once to bf16, in both types M, x w and the
    state rounded once);
  - ``two_pass`` (float32): hi*hi + hi*lo, without the lo*hi term;
  - ``m_once``: M = G decay dt rounded once to bf16, without its low part.

Every line is JSON with the card's name and power limit.  The variants are
probes, not kernels of the port: the timings of the other variants carry
wrong results on purpose.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
OUT = ROOT / "build" / "probe_ssd"

_NO_LOAD = ("#include \"hopper.cuh\"\n",
            "#include \"hopper.cuh\"\n"
            "template <typename... A> __device__ void no_load(A...) {}\n")
_WGMMA = re.compile(r"^\s*hopper::wgmma_bf16_\w+<\w+>\(.*\);\n", re.M)


def _drop_products(tokens):
    """A substitution that deletes every ``wgmma`` line naming one of
    ``tokens`` (an operand's low part)."""
    def sub(text: str) -> tuple[str, int]:
        hits = 0
        out = []
        for line in text.splitlines(keepends=True):
            if _WGMMA.match(line) and any(t in line for t in tokens):
                hits += 1
                continue
            out.append(line)
        return "".join(out), hits
    return sub


#: (old, new) replacements, or a function text -> (text, hits); an old
#: string is a regular expression when it is compiled.
VARIANTS = {
    "as_is": [],
    "no_loads": [
        _NO_LOAD,
        ("hopper::tma_load_3d(", "no_load("),
        ("hopper::tma_load_4d(", "no_load("),
        (re.compile(r"hopper::mbar_arrive_expect_tx\(([^,]+),[^;]*\);"),
         r"hopper::mbar_arrive(\1);"),
        (re.compile(r"(?<!void )copy_(piece|box)\("), "no_load("),
    ],
    "no_products": [(_WGMMA, "")],
    "no_state_chain": [("      hopper::mbar_wait(sfull, c & 1);\n", ""),
                       ("      hopper::mbar_wait(sempty, c & 1);\n", "")],
    "one_pass": [_drop_products(("al,", "al[kk]", "desc_c(1, kk)", "b1)",
                                 "x1)", "s1)"))],
    "two_pass": [_drop_products(("al,", "al[kk]", "desc_c(1, kk)"))],
    "m_once": [_drop_products(("(part, al, x0)",))],
}
TIMED = ("as_is", "no_loads", "no_products", "no_state_chain")
ACCURACY = {"bfloat16": ("as_is", "one_pass", "m_once"),
            "float32": ("as_is", "one_pass", "two_pass", "m_once")}
SHAPE = (2, 4096, 64, 64, 128)   # batch, steps, heads, P, N
CHUNK = 128


def variant_source(text: str, subs) -> str:
    """``text`` with every replacement of ``subs`` made; raises if one of
    them no longer matches."""
    for sub in subs:
        if callable(sub):
            text, hits = sub(text)
            what = sub
        else:
            old, new = sub
            what = old
            if isinstance(old, re.Pattern):
                text, hits = old.subn(new, text)
            else:
                hits = text.count(old)
                text = text.replace(old, new)
        if not hits:
            raise SystemExit(f"the source no longer holds {what!r}")
    return text


def build_variants(nvcc: str, flags) -> dict:
    """{name: launch function} of every variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    sources = {name: variant_source(text, subs)
               for name, subs in VARIANTS.items()}
    procs = {}
    for name, source in sources.items():
        path = OUT / f"{name}.cu"
        path.write_text(source)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(SRC.parent), "-o",
             str(OUT / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        launch = ctypes.CDLL(str(OUT / f"lib{name}.so")).ssd_scan_launch
        launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        fns[name] = launch
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.tolerance import limits

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = build_variants(build.nvcc_path(), build.NVCC_FLAGS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, s, h, p, n = SHAPE

    def run(name, args, out):
        x, dt, A, Bm, Cm = args
        ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), out.data_ptr(), b, s, h, p, n, CHUNK,
                build.DTYPE_CODES[x.dtype])

        def call():
            err = fns[name](*ptrs, torch.cuda.current_stream().cuda_stream)
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

    for dtype in (torch.float32, torch.bfloat16):
        def r(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        args = (r(b, s, h, p).to(dtype),
                (F.softplus(r(b, s, h)) * 0.5).to(dtype),
                -torch.exp(r(h) * 0.3), (r(b, s, n) * 0.5).to(dtype),
                (r(b, s, n) * 0.5).to(dtype))
        out = torch.empty_like(args[0])
        name = str(dtype).split(".")[-1]
        emit(probe="time", dtype=name, shape=list(SHAPE), chunk=CHUNK,
             **{f"{v}_ms": ms(run(v, args, out)) for v in TIMED})
        want = ssd_scan_plain(*args, chunk=CHUNK)
        atol, rtol = limits("ssd_scan", want)
        w = want.float()
        counts = {}
        for v in ACCURACY[name]:
            run(v, args, out)()
            torch.cuda.synchronize()
            x = out.float()
            counts[v] = (int((~torch.isclose(x, w, atol=atol,
                                             rtol=rtol)).sum()),
                         float((x - w).abs().max()))
        emit(probe="accuracy", dtype=name, shape=list(SHAPE), chunk=CHUNK,
             outputs=out.numel(), atol=atol, rtol=rtol,
             beyond_limit_and_max_abs_err=counts)
        del args, out, want, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
