"""Atomic, async checkpoints (counterpart of :mod:`repro.checkpoint.ckpt`),
in the reference's on-disk layout.

Layout: one ``step_%010d`` directory per step holding ``<leaf>.npy``
files and a msgpack manifest (``manifest.msgpack``: per leaf its file,
dtype and shape, plus the caller's ``extra`` state).  Writes go to
``<dir>.tmp`` and are renamed into place; ``LATEST`` is written last,
through ``LATEST.tmp`` and ``os.replace``, so a crash mid-save never
corrupts the restore point.  ``save_async`` snapshots to host memory at
once and writes in a background thread.

A tree is nested dicts, lists, tuples and NamedTuples of numpy arrays
and tensors (``None`` holds no leaf), flattened in ``jax.tree_util``'s
order (dict keys sorted, sequences in order) and named by its path, as
``jax.tree_util.tree_flatten_with_path`` names it: the dict key, the
sequence index, or ``.<field>`` for a NamedTuple's field (an optimizer
state's ``opt/.master/w``), joined with ``/`` and stored as ``__``.  So
the reference and the port read each other's checkpoints.  bfloat16 and
float8_e4m3fn leaves are written as their uint16 and uint8 bits with the
manifest dtype ``"bfloat16"`` or ``"float8_e4m3fn"``, as the reference
writes them, through ``torch``'s ``view`` (the port does not use
``ml_dtypes``).  The manifest goes through the port's own msgpack codec
(:mod:`repro_torch.checkpoint._msgpack`), whose bytes equal
``msgpack.packb``'s.

A restore takes each leaf's dtype from ``like``: a tensor leaf comes back
as a tensor on that leaf's device, a numpy leaf as a numpy array.
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
import torch

from repro_torch.checkpoint import _msgpack

#: Leaf dtypes stored as unsigned views, as the reference stores them.
_VIEW_DTYPES = {"bfloat16": (torch.bfloat16, torch.uint16, np.uint16),
                "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8,
                                  np.uint8)}
_VIEW_NAMES = {torch_dtype: name
               for name, (torch_dtype, _, _) in _VIEW_DTYPES.items()}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """(path key, child) pairs of a container in ``jax.tree_util``'s
    order."""
    if isinstance(tree, dict):
        return [(key, tree[key]) for key in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{field}", getattr(tree, field))
                for field in tree._fields]
    return list(enumerate(tree))


def _leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s flattening order."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [pair for key, child in _children(tree)
                for pair in _leaves(child, path + (key,))]
    return [(path, tree)]


def _name(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_disk(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the host array written to disk (bfloat16 and float8 as
    their unsigned bits) and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _VIEW_NAMES:
            name = _VIEW_NAMES[t.dtype]
            return t.view(_VIEW_DTYPES[name][1]).numpy(), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _VIEW_DTYPES:   # an ml_dtypes array handed in by a caller
        return arr.view(_VIEW_DTYPES[name][2]), name
    return arr, name


def _flatten_with_names(tree) -> Dict[str, np.ndarray]:
    """Each leaf as its host array on disk, by name."""
    return {_name(path): _to_disk(leaf)[0] for path, leaf in _leaves(tree)}


def _host_copy(leaf):
    """A copy of a leaf in host memory (tensors stay tensors)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _rebuild(tree, values: Dict[str, Any], path: Tuple = ()):
    """``tree``'s structure with each leaf replaced by ``values[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(item, values, path + (key,))
                for key, item in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_rebuild(child, values, path + (key,))
                    for key, child in _children(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*children)
        return type(tree)(children)
    return values[_name(path)]


def _restored(arr: np.ndarray, dtype: str, like):
    """The array read from disk as ``like``'s kind of leaf and dtype: a
    tensor on ``like``'s device, or a numpy array."""
    t = torch.from_numpy(arr)
    if dtype in _VIEW_DTYPES:
        t = t.view(_VIEW_DTYPES[dtype][0])
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if dtype in _VIEW_DTYPES:   # numpy has no bfloat16 or float8
        arr = t.to(torch.float32).numpy()
    if hasattr(like, "dtype") and arr.dtype != np.dtype(like.dtype):
        arr = arr.astype(like.dtype)
    return arr


def save_pytree(tree, directory: pathlib.Path,
                extra: Optional[Dict] = None,
                rate_limit_mbps: Optional[float] = None) -> None:
    directory = pathlib.Path(directory)
    flat = {_name(path): _to_disk(leaf) for path, leaf in _leaves(tree)}
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"leaves": {}, "extra": extra or {}}
    for name, (arr, dtype) in flat.items():
        fn = name.replace("/", "__") + ".npy"
        t0 = time.monotonic()
        np.save(tmp / fn, arr)
        if rate_limit_mbps:
            expect = arr.nbytes / (rate_limit_mbps * 1e6)
            sleep = expect - (time.monotonic() - t0)
            if sleep > 0:
                time.sleep(sleep)
        manifest["leaves"][name] = {
            "file": fn, "dtype": dtype, "shape": list(arr.shape)}
    (tmp / "manifest.msgpack").write_bytes(_msgpack.packb(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(directory: pathlib.Path, like) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a tree of arrays or
    tensors), each leaf of the ``like`` leaf's dtype: a tensor on its
    device, or a numpy array.  Returns (tree, extra)."""
    directory = pathlib.Path(directory)
    manifest = _msgpack.unpackb(
        (directory / "manifest.msgpack").read_bytes())
    leaves_meta = manifest["leaves"]
    arrays = {}
    for path, leaf in _leaves(like):
        name = _name(path)
        meta = leaves_meta[name]
        arrays[name] = _restored(np.load(directory / meta["file"]),
                                 meta["dtype"], leaf)
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
        snapshot = _rebuild(tree, {_name(path): _host_copy(leaf)
                                   for path, leaf in _leaves(tree)})

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
