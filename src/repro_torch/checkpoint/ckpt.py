"""Atomic, async checkpoints (counterpart of :mod:`repro.checkpoint.ckpt`),
in the reference's on-disk layout.

Layout: one ``step_%010d`` directory per step holding ``<leaf>.npy``
files and a msgpack manifest (``manifest.msgpack``: per leaf its file,
dtype and shape, plus the caller's ``extra`` state).  Writes go to
``<dir>.tmp`` and are renamed into place; ``LATEST`` is written last,
through ``LATEST.tmp`` and ``os.replace``, so a crash mid-save never
corrupts the restore point.  ``save_async`` snapshots to host memory at
once and writes in a background thread.

A tree is nested dicts, lists and tuples of numpy arrays and tensors,
flattened in ``jax.tree_util``'s order (dict keys sorted, sequences in
order) and named by its path (the dict key or the sequence index, joined
with ``/``, stored as ``__``): the reference and the port read each
other's checkpoints.  The manifest goes through the port's own msgpack
codec (:mod:`repro_torch.checkpoint._msgpack`), whose bytes equal
``msgpack.packb``'s.  bfloat16 and float8 leaves are refused for now
(ROADMAP Queue A, item 5).
"""
from __future__ import annotations

import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import _msgpack

#: Leaf dtypes the reference stores as unsigned views (``ml_dtypes``);
#: the port does not store them yet.
_VIEW_DTYPES = ("bfloat16", "float8_e4m3fn")


def _refuse_view_dtype(name: str, dtype: str) -> None:
    if dtype in _VIEW_DTYPES or dtype.startswith(("torch.bfloat16",
                                                  "torch.float8")):
        raise TypeError(
            f"checkpoint leaf {name!r} has dtype {dtype}: bfloat16 and "
            f"float8 leaves are not supported yet (ROADMAP Queue A, "
            f"item 5)")


def _leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_leaves(tree[key], path + (key,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out.extend(_leaves(item, path + (i,)))
        return out
    return [(path, tree)]


def _name(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(name: str, leaf) -> np.ndarray:
    """A leaf as a host numpy array (tensors: ``.cpu().numpy()``)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        _refuse_view_dtype(name, str(leaf.dtype))
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    _refuse_view_dtype(name, str(arr.dtype))
    return arr


def _flatten_with_names(tree) -> Dict[str, np.ndarray]:
    return {_name(path): _to_numpy(_name(path), leaf)
            for path, leaf in _leaves(tree)}


def _rebuild(tree, values: Dict[str, np.ndarray], path: Tuple = ()):
    """``tree``'s structure with each leaf replaced by ``values[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(item, values, path + (key,))
                for key, item in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, values, path + (i,))
                          for i, item in enumerate(tree))
    return values[_name(path)]


def _numpy_dtype(leaf) -> Optional[np.dtype]:
    """The numpy dtype of a ``like`` leaf (tensor or array), if it has one."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype) if hasattr(leaf, "dtype") else None


def save_pytree(tree, directory: pathlib.Path,
                extra: Optional[Dict] = None,
                rate_limit_mbps: Optional[float] = None) -> None:
    directory = pathlib.Path(directory)
    flat = _flatten_with_names(tree)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"leaves": {}, "extra": extra or {}}
    for name, arr in flat.items():
        fn = name.replace("/", "__") + ".npy"
        t0 = time.monotonic()
        np.save(tmp / fn, arr)
        if rate_limit_mbps:
            expect = arr.nbytes / (rate_limit_mbps * 1e6)
            sleep = expect - (time.monotonic() - t0)
            if sleep > 0:
                time.sleep(sleep)
        manifest["leaves"][name] = {
            "file": fn, "dtype": str(arr.dtype), "shape": list(arr.shape)}
    (tmp / "manifest.msgpack").write_bytes(_msgpack.packb(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(directory: pathlib.Path, like) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a tree of arrays or
    tensors), each leaf a numpy array of the ``like`` leaf's dtype.
    Returns (tree, extra)."""
    directory = pathlib.Path(directory)
    manifest = _msgpack.unpackb(
        (directory / "manifest.msgpack").read_bytes())
    leaves_meta = manifest["leaves"]
    arrays = {}
    for path, leaf in _leaves(like):
        name = _name(path)
        meta = leaves_meta[name]
        _refuse_view_dtype(name, meta["dtype"])
        arr = np.load(directory / meta["file"])
        dtype = _numpy_dtype(leaf)
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        arrays[name] = arr
    return _rebuild(like, arrays), manifest.get("extra", {})


class CheckpointManager:
    """keep-last-k manager with async save and crash-safe restore."""

    def __init__(self, root: pathlib.Path, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.write_rate_limit_mbps: Optional[float] = None  # CBP bw knob

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:010d}"

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        save_pytree(tree, self._step_dir(step), extra,
                    rate_limit_mbps=self.write_rate_limit_mbps)
        (self.root / "LATEST.tmp").write_text(str(step))
        os.replace(self.root / "LATEST.tmp", self.root / "LATEST")
        self._gc()

    def save_async(self, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        """Snapshot now (a host copy of every leaf), write in the
        background."""
        self.wait()
        snapshot = _rebuild(tree, {name: arr.copy() for name, arr in
                                   _flatten_with_names(tree).items()})

        def _write():
            self.save(step, snapshot, extra)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        latest = self.root / "LATEST"
        if not latest.exists():
            return None
        step = int(latest.read_text().strip())
        if not self._step_dir(step).exists():
            # crash between data write and LATEST update: fall back
            steps = self.all_steps()
            return steps[-1] if steps else None
        return step

    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            m = re.match(r"step_(\d+)$", p.name)
            if m and (p / "manifest.msgpack").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, like) -> Optional[Tuple[int, Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = load_pytree(self._step_dir(step), like)
        return step, tree, extra

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
