#!/usr/bin/env python3
"""Probe what bounds the ``cbp_matmul`` CUDA kernel on the card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/matmul_probe.py

It builds variants of ``src/repro_torch/csrc/cbp_matmul.cu``, each the
source with a few lines replaced, into ``build/probe/`` (one ``nvcc``
each, all at once), loads them with ``ctypes`` and, in one process on one
card:

* times each at the qwen3-8b FFN shape (4096 x 4096 @ 4096 x 12288,
  bf16) for ``block_m = block_n = 128`` and several ``block_k``, beside
  ``torch.matmul``:

  - ``as_is``: the kernel;
  - ``loads_only``: the ring without the products (what the TMA feed
    alone takes);
  - ``products_only``: the products without the loads (the producer
    marks each stage full at once; what the tensor cores and the
    barriers alone take);
  - ``row_order``: blocks take regions in plain row order, not in
    groups of 8 region rows;
  - ``kt64``: 64 k a stage (A rows of 128 bytes) instead of 32;

* counts, at the same shape in float32 and with ``block_k = 128``, the
  outputs beyond the f32 limit of ``repro_torch.kernels.tolerance``
  (atol = rtol = 1e-4) from the float64 product, for the kernel, for
  ``one_accumulator`` (its 3xTF32 products summed into one accumulator
  over all of k) and for ``torch.matmul`` in float32 (TF32 off).

Every line is JSON with the card's name and power limit.  The variants
are probes, not kernels of the port: the timings of the other variants
carry wrong results on purpose.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "cbp_matmul.cu"
OUT = ROOT / "build" / "probe"

_MMA_BF16 = "          hopper::wgmma_bf16<kTile>(acc, da, db);"
_TMA_A = ("          hopper::mbar_arrive_expect_tx(&full[s], kStage);\n"
          "          hopper::tma_load_2d(st, &map_a, &full[s], kb * kT, tm);")
_TMA_B = "          for (int j = 0; j < kTile / Tr::kBBox; ++j)\n"
_KT64 = [
    ("constexpr int kT = 32; ", "constexpr int kT = 64; "),
    ("static constexpr int kASw = 64, kBSw = 128",
     "static constexpr int kASw = 128, kBSw = 128"),
    ("hopper::smem_desc<64>(\n              st + c * 64 * kT * 2 + 32 * kk, "
     "16, 512)",
     "hopper::smem_desc<128>(\n              st + c * 64 * kT * 2 + 32 * kk, "
     "16, 1024)"),
]
VARIANTS = {
    "as_is": [],
    "loads_only": [(_MMA_BF16, "          if (da == 0) " + _MMA_BF16[10:])],
    "products_only": [
        (_TMA_A, "          hopper::mbar_arrive(&full[s]);"),
        (_TMA_B, "          for (int j = 0; j < 0; ++j)\n")],
    "row_order": [("  region_of(blockIdx.x + blockIdx.y * gridDim.x, gridDim.y, "
                   "gridDim.x, rm,\n            rn);",
                   "  rm = blockIdx.y, rn = blockIdx.x;")],
    "kt64": _KT64,
    "one_accumulator": [
        ("          hopper::fence_operands(part);\n#pragma unroll\n"
         "          for (int i = 0; i < kTile / 2; ++i) acc[i] += part[i];",
         "          hopper::fence_operands(acc);"),
        ("      hopper::fence_operands(part);\n#pragma unroll\n"
         "      for (int i = 0; i < kTile / 2; ++i) acc[i] += part[i];",
         "      hopper::fence_operands(acc);"),
        ("hopper::wgmma_tf32<kTile>(part,", "hopper::wgmma_tf32<kTile>(acc,")],
}
BLOCK_KS = (64, 128, 256)
TIMED = ("as_is", "loads_only", "products_only", "row_order", "kt64")


def build_variants(nvcc: str, flags) -> dict:
    """{name: (launch, smem_bytes)} of every variant that builds."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: the source no longer "
                                 f"holds {old!r}")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(SRC.parent), "-o",
             str(OUT / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        launch = lib.cbp_matmul_launch
        launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        lib.cbp_matmul_smem_bytes.restype = ctypes.c_int
        fns[name] = (launch, lib.cbp_matmul_smem_bytes)
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("matmul_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.cbp_matmul.ops import _launch_args

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = build_variants(build.nvcc_path(), build.NVCC_FLAGS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def run(name, a, b, out, knobs):
        launch, smem = fns[name]
        args = _launch_args(a, b, out, *knobs)
        args = (*args[:-1], smem(*knobs, a.element_size()))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = launch(*args, stream)
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

    shape = (4096, 4096, 12288)
    M, K, N = shape
    a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    b = torch.randn(K, N, generator=gen, device="cuda").bfloat16()
    out = torch.empty(M, N, dtype=a.dtype, device="cuda")
    for bk in BLOCK_KS:
        knobs = (128, 128, bk)
        emit(probe="time", dtype="bfloat16", shape=shape, knobs=knobs,
             torch_matmul_ms=ms(lambda: torch.matmul(a, b)),
             **{f"{n}_ms": ms(run(n, a, b, out, knobs)) for n in TIMED})
    del a, b, out

    a = torch.randn(M, K, generator=gen, device="cuda")
    b = torch.randn(K, N, generator=gen, device="cuda")
    exact = torch.matmul(a.double(), b.double())
    limit = 1e-4 + 1e-4 * exact.abs()

    def beyond(x):
        return int(((x.double() - exact).abs() > limit).sum())

    out = torch.empty(M, N, device="cuda")
    counts = {}
    for name in ("as_is", "one_accumulator"):
        run(name, a, b, out, (128, 128, 128))()
        torch.cuda.synchronize()
        counts[name] = beyond(out)
    counts["torch_matmul_f32"] = beyond(torch.matmul(a, b))
    emit(probe="accuracy", dtype="float32", shape=shape,
         knobs=(128, 128, 128), outputs=M * N,
         beyond_f32_limit_of_the_f64_product=counts,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
