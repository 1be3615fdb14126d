"""Sharding plans: pod-scale spatial unrolling of the model loop nest; port
of ``repro/parallel/sharding.py``.

In the paper's taxonomy (core/dataflow.py) a distributed mapping is a spatial
unrolling of loops onto physical dims.  Here the physical dims are the
dimensions of a torch ``DeviceMesh``:

    batch (B)          -> ('pod', 'data')     data parallel (+ pod DP)
    d_model / hidden   -> 'data'  (FSDP: params/opt-state sharded, gathered
                                   on use - ZeRO-3)
    heads / d_ff / V   -> 'model' (tensor parallel)
    KV-cache sequence  -> 'model' (flash-decoding style sequence sharding)

Rules are path-based over the port's nested dict trees; every rule degrades
to replication when a dim is not divisible by the axis size (uneven vocab
like granite-moe's 49155 stays replicated rather than failing to shard).

A spec keeps the reference's form (:class:`P`): one entry per tensor
dimension, each None, a mesh axis name, or a tuple of axis names.
:func:`placements` turns it into DTensor placements, one per mesh
dimension, and :meth:`ShardingPlan.place` distributes a tree by a tree of
specs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

# (path substring, spec for the TRAILING dims; leading dims -> None)
PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    ("embed/tok", ("model", "data")),
    ("embed/unembed", ("data", "model")),
    ("patch_proj", (None, "model")),
    ("/wq", ("data", "model")),
    ("/wk", ("data", "model")),
    ("/wv", ("data", "model")),
    ("/wg", ("data", "model")),
    ("/wr", ("data", "model")),
    ("/wo", ("model", "data")),
    ("mlp/w_in", ("data", "model")),
    ("mlp/w_gate", ("data", "model")),
    ("mlp/w_out", ("model", "data")),
    ("moe/router", (None, None)),
    ("moe/w_in", (None, "data", "model")),
    ("moe/w_gate", (None, "data", "model")),
    ("moe/w_out", (None, "model", "data")),
    ("w_lora_a", ("data", None)),
    ("w_lora_b", (None, "data")),
    ("rnn/w_y", ("data", "model")),
    ("rnn/w_x", ("data", "model")),
    ("rnn/w_a", ("data", "model")),
    ("rnn/w_i", ("data", "model")),
    ("rnn/w_o", ("model", "data")),
)


class P(tuple):
    """A partition spec: one entry per tensor dimension (None, an axis
    name, or a tuple of axis names), as ``jax.sharding.PartitionSpec``,
    which also stores a one-name tuple as the name and an empty one as
    None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _path_str(path) -> str:
    """'/'-joined keys of a path (dict keys, or JAX key-path entries with
    ``.key`` / ``.idx``)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict tree; None subtrees stay None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def axis_names(mesh) -> tuple[str, ...]:
    """A torch ``DeviceMesh``'s dimension names, or ``mesh.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}; a ``DeviceMesh``'s ``shape`` is a tuple, a
    stand-in mesh's a dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in axis_names(self.mesh))

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return axis_sizes(self.mesh)[name]

    def _fit(self, shape: tuple[int, ...], spec: Sequence) -> P:
        """Drop axes that do not evenly divide their dim (graceful fallback).
        The FSDP axis 'data' expands to all DP axes (pod included) so ZeRO
        sharding scales with the full data-parallel world size."""
        full = [None] * (len(shape) - len(spec)) + list(spec)
        fixed = []
        for dim, ax in zip(shape, full):
            if ax == "data":
                dp = self.dp_axes
                ax = dp if len(dp) > 1 else dp[0]
            if ax is not None and dim % self.axis_size(ax) == 0 and dim > 0:
                fixed.append(ax)
            else:
                fixed.append(None)
        return P(*fixed)

    # -------------------------------------------------------------- params --
    def param_spec(self, shapes: Any, fsdp: bool = True) -> Any:
        """fsdp=False (serving): params TP-sharded over 'model' only and
        replicated over the data axes - no per-step param all-gather."""
        def one(path, leaf):
            ps = _path_str(path)
            for key, spec in PARAM_RULES:
                if key in ps:
                    use = spec if fsdp else tuple(
                        None if ax == "data" else ax for ax in spec
                    )
                    return self._fit(tuple(leaf.shape), use)
            return P(*([None] * len(leaf.shape)))

        return map_with_path(one, shapes)

    def opt_state_spec(self, param_specs: Any) -> dict:
        return {
            "m": param_specs,
            "v": param_specs,
            "step": P(),
        }

    # --------------------------------------------------------------- batch --
    def batch_spec(self, shapes: Any) -> Any:
        dp = self.dp_axes

        def one(_, leaf):
            if not leaf.shape:
                return P()
            spec = [None] * len(leaf.shape)
            if leaf.shape[0] % self.axis_size(dp) == 0:
                spec[0] = dp
            return P(*spec)

        return map_with_path(one, shapes)

    # -------------------------------------------------------------- caches --
    def cache_spec(self, shapes: Any) -> Any:
        """KV caches: batch over DP axes, cache sequence over 'model'
        (flash-decoding style); recurrent states: width/heads over 'model'."""
        dp = self.dp_axes

        def one(path, leaf):
            ps = _path_str(path)
            shape = tuple(leaf.shape)
            name = ps.rsplit("/", 1)[-1]
            spec: list = [None] * len(shape)
            if name in ("k", "v"):
                # (..., B, size, KV, hd)
                b_i, s_i = len(shape) - 4, len(shape) - 3
                if shape[b_i] % self.axis_size(dp) == 0:
                    spec[b_i] = dp
                # sequence-shard only LARGE caches: sharding a small ring
                # buffer turns every insert into a replicate-then-partition
                # reshard - §Perf
                if (shape[s_i] % self.axis_size("model") == 0
                        and shape[s_i] >= 4096):
                    spec[s_i] = "model"
            elif name == "pos":
                s_i = len(shape) - 1
                if (shape[s_i] % self.axis_size("model") == 0
                        and shape[s_i] >= 4096):
                    spec[s_i] = "model"
            elif name == "state":
                # (..., B, H, dk, dv)
                b_i, h_i = len(shape) - 4, len(shape) - 3
                if shape[b_i] % self.axis_size(dp) == 0:
                    spec[b_i] = dp
                if shape[h_i] % self.axis_size("model") == 0:
                    spec[h_i] = "model"
            elif name in ("h", "x_prev", "conv"):
                b_i = 1 if len(shape) > 2 else 0
                # trailing width dim over model
                if shape[-1] % self.axis_size("model") == 0:
                    spec[-1] = "model"
                if len(shape) > 1 and shape[b_i] % self.axis_size(dp) == 0:
                    spec[b_i] = dp
            return P(*spec)

        return map_with_path(one, shapes)


    # ------------------------------------------------------------- helpers --
    def shardings(self, spec_tree: Any) -> Any:
        """The ``(mesh, placements)`` pair of every spec in ``spec_tree``
        (the reference's ``named``), as ``ckpt.restore(shardings=)`` takes
        them."""
        return map_with_path(lambda _, spec: (self.mesh, placements(self.mesh, spec)),
                             spec_tree)

    def place(self, tree: Any, spec_tree: Any) -> Any:
        """Every leaf of ``tree`` as a DTensor on the plan's mesh laid out by
        its spec in ``spec_tree`` (the reference's ``named`` and
        ``device_put``).  Each rank keeps its own slice of the leaf it holds
        (no collective), so every rank must hold the same values; fake
        tensors are placed without allocating."""
        from torch.distributed.tensor import distribute_tensor

        def one(path, leaf):
            spec = spec_tree
            for k in path:
                spec = spec[k]
            return distribute_tensor(leaf, self.mesh, placements(self.mesh, spec),
                                     src_data_rank=None)

        return map_with_path(one, tree)


# ------------------------------------------------------------- DTensors --


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` on every mesh dimension that tensor dimension ``d``'s entry
    names (``("pod", "data")`` shards d on both), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names(mesh))
    index = {name: i for i, name in enumerate(axis_names(mesh))}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[index[name]] = Shard(d)
    return out
