"""Production mesh definitions (counterpart of :mod:`repro.launch.mesh`).

Each is a FUNCTION: importing this module starts no process group.  A
mesh spans one process a device (:func:`repro_torch.distributed.
start_ranks` joins each); the production meshes need exactly their
device count of ranks.
"""
from __future__ import annotations

from repro_torch.device import DeviceLike
from repro_torch.distributed import make_mesh, mesh_axes


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """Single pod: (16, 16) = ("data", "model"), 256 devices.  Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512 devices.  Raises a
    ``ValueError`` naming the ranks it needs on a group of another
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None):
    """One-device mesh (axes present, size 1) over one process."""
    return make_mesh((1, 1), ("data", "model"), device)


def dp_size(mesh) -> int:
    names, sizes = mesh_axes(mesh)
    n = 1
    for a in ("pod", "data"):
        if a in names:
            n *= sizes[a]
    return n


def model_size(mesh) -> int:
    return mesh_axes(mesh)[1].get("model", 1)
