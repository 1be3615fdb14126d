"""Distributed-optimization tricks: gradient compression; port of
``repro/parallel/collectives.py``.

int8 gradient all-reduce with error feedback (1-bit-Adam family, adapted):
each data shard quantizes its local gradient to int8 with a per-block scale,
all-reduces the int8 payload (as int32 accumulators to avoid overflow at
512-way reductions), dequantizes, and keeps the quantization residual as
error feedback added to the next step's gradient.  Cuts DP gradient traffic
~2x (bf16->int8) to ~4x (fp32->int8) on the wire.

The reference's ``shard_map`` + ``lax.psum`` become two
``torch.distributed.all_reduce`` calls over the mesh axis's process group.
As in the reference, the training loop leaves ``TrainConfig.compress_grads``
unused: this module is the function and its tests.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import axis_names
from repro_torch.train.optim import tree_leaves, tree_map, tree_unflatten

BLOCK = 256


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization. x: (N,) fp32 (N % BLOCK == 0).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xb = x.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x flattened to fp32 and zero-padded to a multiple of BLOCK."""
    flat = x.reshape(-1).float()
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Reference (single-host) quantize->dequantize for error-bound tests."""
    q, s = _quantize(_padded(x))
    return _dequantize(q, s)[: x.numel()].reshape(x.shape)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """int8-compressed all-reduce of a replicated-layout tensor over
    ``axis`` of ``mesh`` (a ``DeviceMesh``).

    The payload crosses the wire as int8 (summed in int32); the result is
    the dequantized mean, fp32 (approximation: shared scale sum; exact when
    shards have equal scales)."""
    group = mesh.get_group(axis_names(mesh).index(axis))
    n_dev = dist.get_world_size(group)
    q, s = _quantize(_padded(x))
    # all-reduce the int8 payloads (as int32 accumulators) and scales apart
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = s.clone()
    dist.all_reduce(ssum, group=group)
    deq = qsum.float() * (ssum / n_dev) / n_dev
    return deq.reshape(-1)[: x.numel()].reshape(x.shape)


def error_feedback_update(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Add residual, quantize-roundtrip, compute next residual."""

    def one(g, r):
        gf = g.float() + r
        gq = quantize_roundtrip(gf)
        return gq.to(g.dtype), gf - gq

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    return (
        tree_unflatten(grads, [p[0] for p in pairs]),
        tree_unflatten(grads, [p[1] for p in pairs]),
    )


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
