"""Checkpoints: an npz shard and a JSON manifest per step, async save;
port of ``repro/ckpt/checkpoint.py``.

Layout, the reference's:

    <dir>/step_000123/
        manifest.json        {step, leaves: {path: [shape, dtype]}, extra}
        shard_<host>.npz     the leaves, keyed by their '/'-joined paths

Paths join a nested dict's keys with '/' (``params/layers/attn/wq``,
``opt/step``), and the leaves are flattened in JAX's order (keys sorted),
so a checkpoint written by either package restores in the other, bit for
bit.  numpy has no bfloat16, so a bf16 tensor is stored as its uint16
bits and the manifest names its dtype as the reference spells it
(``"bfloat16"``, :func:`dtype_name`); loading views the bits back.  No
``ml_dtypes``.

``AsyncCheckpointer.save_async`` copies every leaf to the host
synchronously (so training may update its tensors in place at once), then
writes on a background thread into a temporary directory that one rename
publishes: a crash mid-save never corrupts the newest checkpoint.

On a mesh, a DTensor leaf is gathered whole (``full_tensor()``, a
collective every rank joins) before its host copy, and only rank 0 writes.
``restore`` puts a leaf onto the device and dtype of the leaf it replaces,
or, with ``shardings=`` (elastic restore), onto a mesh: each leaf of that
tree is a ``(mesh, placements)`` pair (``ShardingPlan.shardings``).  A
checkpoint written with no mesh restores onto a mesh, and the other way
round, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's spelling of a dtype,
    the one the manifests use."""
    return str(dtype).removeprefix("torch.")


def _numpy(host: torch.Tensor) -> np.ndarray:
    """A numpy view of a CPU tensor, bf16 as its uint16 bits (no copy)."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a real copy on every device, through a
    blocking device-to-host transfer), bf16 as its uint16 bits."""
    return _numpy(t.detach().to("cpu", copy=True))


def _from_savable(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """The CPU tensor :func:`_to_savable` stored, ``dtype_str`` its
    manifest dtype."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps a 0-d array 0-d
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _paths(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict in JAX's order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A DTensor's full tensor (every rank gathers it), else the leaf."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _writer() -> bool:
    """Only rank 0 of an open process group writes."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree: Any) -> dict[str, torch.Tensor]:
    """Host copies of the leaves, keyed by path."""
    return {k: _whole(leaf.detach()).to("cpu", copy=True) for k, leaf in _paths(tree)}


def _write(directory: str, step: int, flat: dict[str, torch.Tensor],
           extra: dict | None, host_id: int = 0) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
             **{k: _numpy(v) for k, v in flat.items()})
    manifest = {
        "step": step,
        "leaves": {k: [list(v.shape), dtype_name(v.dtype)] for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(
    directory: str,
    step: int,
    tree: Any,
    extra: dict | None = None,
    host_id: int = 0,
) -> str:
    """Synchronous checkpoint write; returns the final path (on every
    rank; rank 0 writes)."""
    flat = _flatten(tree)
    if not _writer():
        return os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, flat, extra, host_id)


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread; keep the
    newest ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        # snapshot now (device -> host) so training can update in place
        flat = _flatten(tree)
        if not _writer():
            return

        def _run():
            _write(self.directory, step, flat, extra)
            self._gc()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in list_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp0"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (the newest step unless
    ``step`` is given), every leaf in the dtype of the leaf of ``like`` it
    replaces: onto that leaf's device, or with ``shardings`` (a tree like
    ``like`` of ``(mesh, placements)`` pairs) as a DTensor on that mesh,
    each rank keeping its slice (elastic re-shard onto the current mesh).
    Returns (tree, the manifest's ``extra``)."""
    from torch.distributed.tensor import distribute_tensor

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    with np.load(os.path.join(path, "shard_0.npz")) as data:
        def rebuild(tree, sharding, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, None if sharding is None else sharding[k],
                                   f"{prefix}{k}/") for k, v in tree.items()}
            key = prefix[:-1]
            t = _from_savable(data[key], manifest["leaves"][key][1])
            if sharding is None:
                return t.to(device=tree.device, dtype=tree.dtype)
            mesh, pl = sharding
            return distribute_tensor(t.to(dtype=tree.dtype), mesh, pl, src_data_rank=None)

        out = rebuild(like, shardings)
    return out, manifest["extra"]
