"""Device meshes; port of ``repro/launch/mesh.py``.

Defined as FUNCTIONS (never module-level constants) so importing this module
opens no process group.  The production meshes are the reference's: 16x16
chips a pod, 2 pods for the multi-pod dry-run; they need a process group of
256 or 512 ranks, which the dry run opens as a fake one
(``launch/dryrun.py``).  The host mesh is whatever ranks the launch has, as
a (data, model) mesh: one rank when the program is not run under
``torchrun``.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type() -> str:
    """The mesh's device type for the open process group: ``cuda`` under
    NCCL, ``cpu`` under gloo or a fake group."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 chips per pod; 2 pods for the multi-pod dry-run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a process group of "
                           f"{n} ranks (the dry run opens a fake one)")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """The launch's ranks as a (world, 1) ``("data", "model")`` mesh.

    With no process group open yet: under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) it joins the group of the environment, NCCL for
    ``cuda`` and gloo for ``cpu``; otherwise it opens a one-rank group
    through a ``FileStore`` in a temporary directory (no port to pick).
    On ``cuda`` each rank takes the card ``LOCAL_RANK`` names."""
    device = torch.device(device).type
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            d = tempfile.mkdtemp(prefix="repro_torch_pg_")
            atexit.register(shutil.rmtree, d, True)
            store = dist.FileStore(os.path.join(d, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return init_device_mesh(device, (dist.get_world_size(), 1), mesh_dim_names=("data", "model"))
