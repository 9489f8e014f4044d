"""Build the port's CUDA kernels and load them with ``ctypes``.

Each source ``src/repro_torch/csrc/<name>.cu`` exports a plain C launch
function ``<name>_launch`` that returns ``cudaGetLastError()`` and
``<name>_error_string``; :func:`launcher` binds the pair.
:func:`build_all` compiles every source with its own ``nvcc`` process,
all started together, into ``build/lib<name>-<digest>.so`` at the root
of the checkout (``.gitignore`` lists ``build/``); the digest covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source never loads a stale library.  :func:`load` builds on first use.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

#: Kernel sources under ``csrc/``, one shared library each.
SOURCES = ("lookahead_greedy", "cbp_matmul", "flash_attention",
           "flash_decode", "ssd_scan")

#: The ``dtype`` argument of the launchers that take float tensors.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: ``ctypes`` argument types of a launcher: device pointers and the stream
#: are ``ptr`` (a bare ``int`` would be cut to 32 bits).
ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels.  No
# -use_fast_math: the f64 kernels promise bit parity with their plain
# versions.  -Xptxas -v reports registers and shared memory per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHERS: Dict[str, Callable[..., None]] = {}


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """``build/lib<name>-<digest>.so``; the digest covers the source, the
    shared headers of ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all running at once.  Returns the compiler's
    output (the ``-Xptxas -v`` report) per kernel it built; raises
    ``RuntimeError`` with that output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def launcher(name: str, argtypes: Sequence) -> Callable[..., None]:
    """``<name>_launch`` of the kernel's library with its C signature
    declared (the stream is appended as the last argument).  The returned
    function launches on the current stream of the current device and
    raises ``RuntimeError`` if the launch is refused; it never
    synchronises."""
    if name in _LAUNCHERS:
        return _LAUNCHERS[name]
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, ptr]
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def launch(*args) -> None:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"({err_str(err).decode()})")

    _LAUNCHERS[name] = launch
    return launch
