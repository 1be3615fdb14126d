"""Logical-axis activation sharding policy; port of
``repro/parallel/policy.py``.

Model code names activation dims logically (batch/seq/heads/ff/vocab/...);
launchers activate a mapping from logical names to mesh axes, and
``shard(x, ...)`` lays a DTensor activation out by it (the reference's
``with_sharding_constraint``).  When no policy is active (CPU unit tests,
every serve path) it returns ``x`` itself, so model code stays
mesh-agnostic; on a plain tensor (one rank's local tensor) it does too.
While a policy is active, plain tensors that meet DTensors in an operation
count as replicated (``implicit_replication``).

This is the pod-scale analogue of the paper's `in`/`compute_at`: the policy
pins which loop dims live on which physical array dimension, and DTensor's
redistribution materializes the data movement that choice implies (visible
in the dry-run's collective bytes).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Mapping

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.parallel.sharding import P, axis_names, axis_sizes, placements

_ACTIVE: dict[str, Any] | None = None
_AXIS_SIZES: dict[str, int] | None = None


def default_rules(mesh) -> dict[str, Any]:
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    dp_ax = dp if len(dp) > 1 else (dp[0] if dp else None)
    return {
        "batch": dp_ax,
        "seq": None,
        "embed": None,          # residual stream replicated across 'model'
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "expert": None,
        "cap": None,
        "kv_seq": "model",      # flash-decoding style KV sharding
    }


@contextlib.contextmanager
def activate(mesh, rules: Mapping[str, Any] | None = None):
    global _ACTIVE, _AXIS_SIZES
    prev, prev_sizes = _ACTIVE, _AXIS_SIZES
    _ACTIVE = dict(default_rules(mesh))
    if rules:
        _ACTIVE.update(rules)
    _AXIS_SIZES = axis_sizes(mesh)
    try:
        # tensors the model makes itself (positions, masks, zero states)
        # join DTensor arithmetic as replicated
        with implicit_replication():
            yield
    finally:
        _ACTIVE, _AXIS_SIZES = prev, prev_sizes


def _axis_size(ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(_axis_size(a) for a in ax)
    return _AXIS_SIZES.get(ax, 1)


def spec_of(shape, *logical: str | None) -> P:
    """The active policy's spec for an activation of ``shape`` whose dims
    are named ``logical``; drops axes that don't divide."""
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical names {logical} for shape {tuple(shape)}")
    spec = []
    for dim, name in zip(shape, logical):
        ax = _ACTIVE.get(name) if name else None
        if ax is not None and dim % _axis_size(ax) == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return P(*spec)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Apply the active policy to x: a DTensor is redistributed to the
    policy's placements; with no policy, or on a plain tensor, x itself."""
    if _ACTIVE is None:
        return x
    spec = spec_of(x.shape, *logical)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight at its use: a DTensor split over the data axes ('pod',
    'data': FSDP) gathered over them, its other placements kept, so that a
    product keeps its rows split as the activations are and the weight's
    gradient comes back reduce-scattered.  With no policy, or on a plain
    tensor, ``w`` itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if _ACTIVE is None or not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    pl = [Replicate() if n in ("pod", "data") else p for n, p in zip(names, w.placements)]
    return w if tuple(pl) == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every rank (an all-gather of its shards);
    a plain tensor itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor sharded along ``dim`` gathered along it (its other
    placements kept); anything else itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor) or Shard(dim % x.ndim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p == Shard(dim % x.ndim) else p
                                          for p in x.placements])


def unflatten(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``; a DTensor sharded along ``dim`` over mesh
    dimensions whose sizes do not divide ``sizes[0]`` (15 heads over 16
    ranks) is first gathered along ``dim``, the reshard XLA makes for such
    a reshape and DTensor refuses to make itself."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(x, DTensor):
        split = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                          if p == Shard(dim % x.ndim))
        if sizes[0] % split:
            x = gather_dim(x, dim)
    return x.unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """``x.flatten(start)`` whose backward splits the gradient with
    :func:`unflatten` (a gradient sharded along the merged dimension cannot
    be viewed back into heads that its ranks do not divide)."""

    @staticmethod
    def forward(ctx, x, start):
        ctx.sizes, ctx.start = tuple(x.shape[start:]), start
        return x.flatten(start)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.start, ctx.sizes), None


def flatten(x: torch.Tensor, start: int) -> torch.Tensor:
    """``x.flatten(start)``; for a DTensor, with a gradient split back by
    :func:`unflatten`."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _Flatten.apply(x, start)
    return x.flatten(start)


def write_slots(slots: torch.Tensor, writes) -> None:
    """``cache[b, slots[b, t]] = vals[b, t]`` for every row b and entry t of
    each ``(cache, vals)`` in ``writes`` (slots (B, T), vals (B, T, ...); a
    row's slots distinct).

    A DTensor cache sharded along its rows or slots (the plan shards large
    caches' sequence over 'model') takes the write on each rank's own shard:
    DTensor has no in-place indexed write into a sharded dimension.  Each
    rank writes its rows' in-range entries; an entry outside its slots is
    sent to the position of its row's first in-range entry with that
    entry's value (or, with none in range, to one position with its old
    value), so every index the write repeats carries one value."""
    from torch.distributed.tensor import DTensor

    writes = list(writes)
    if not isinstance(writes[0][0], DTensor):
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        for cache, vals in writes:
            cache[rows, slots] = vals
        return
    if isinstance(slots, DTensor):
        slots = slots.full_tensor()
    for cache, vals in writes:
        _write_shard(cache, slots, vals)


def _write_shard(cache, slots: torch.Tensor, vals) -> None:
    """One DTensor cache's part of :func:`write_slots`, on this rank's shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    local = cache.to_local()
    coord = mesh.get_coordinate()

    def span(d: int) -> tuple[int, int]:
        """(size, offset) of this rank's shard along dimension d (a plan
        shards a dimension only over axes that divide it)."""
        size, off = cache.shape[d], 0
        for i, p in enumerate(cache.placements):
            if p == Shard(d):
                size //= mesh.size(i)
                off += coord[i] * size
        return size, off

    (lb, r0), (ls, s0) = span(0), span(1)
    if isinstance(vals, DTensor):
        # rows as the cache's, every other dimension whole
        vals = vals.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                        for p in cache.placements]).to_local()
    else:
        vals = vals[r0:r0 + lb]
    idx = slots[r0:r0 + lb] - s0                                    # (lb, T)
    inside = (idx >= 0) & (idx < ls)
    first = torch.argmax(inside.to(torch.int8), dim=1, keepdim=True)  # (lb, 1)
    any_in = inside.any(dim=1, keepdim=True)
    target = torch.where(inside, idx, torch.gather(idx, 1, first).clamp(0, ls - 1))
    rows = torch.arange(lb, device=local.device)[:, None].expand_as(target)
    pick = first.reshape((lb, 1) + (1,) * (vals.ndim - 2)).expand((lb, 1) + vals.shape[2:])
    firstval = torch.where(any_in.reshape((lb, 1) + (1,) * (vals.ndim - 2)),
                           torch.gather(vals, 1, pick), local[rows[:, :1], target[:, :1]])
    inside_b = inside.reshape(inside.shape + (1,) * (vals.ndim - 2))
    local[rows, target] = torch.where(inside_b, vals, firstval)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: a local
    tensor's gradient goes back into a DTensor whose global layout is
    contiguous, and a permuted local gradient would disagree with it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_pl, out_pl, grad_pl=None):
    """``fn(*args)`` on each rank's local tensors (torch's ``local_map``).
    ``args`` are tensors: DTensors, or plain tensors whole on every rank;
    each is laid out by its entry of ``in_pl`` (placements, one a mesh
    dimension) and ``fn`` gets the local tensors.  Its outputs become
    DTensors placed by ``out_pl``.  An input's gradient takes its entry of
    ``grad_pl`` where that differs from ``in_pl``: ``Partial()`` on a mesh
    dimension where the input is whole but each rank's ``fn`` uses only its
    part of it (its rows, its slice of a hidden dimension)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]

    def body(*local):
        return fn(*[_ContiguousGrad.apply(t) if t.requires_grad else t for t in local])

    return local_map(body, out_pl, tuple(map(tuple, in_pl)),
                     tuple(map(tuple, grad_pl or in_pl)), mesh,
                     redistribute_inputs=True)(*args)


def gather_rows(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, dim, index)`` along a ``dim`` that no mesh
    dimension splits.  On a mesh each rank gathers on its local tensors:
    ``x`` and ``index`` keep a split of another dimension (rows, features)
    where they have it alike, and a partial sum stays one (the gather is
    linear).  For the backward's sake: DTensor's own gather builds its
    backward's zeros at the whole shape on every rank, so with no gradient
    to track (prefill, decode) it is DTensor's gather that runs."""
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad):
        return torch.gather(x, dim, index)
    x_pl, i_pl = [], []
    for p in x.placements:
        if p.is_shard() and p.dim != dim % x.ndim and index.shape[p.dim] == x.shape[p.dim]:
            x_pl.append(p)
            i_pl.append(p)
        else:
            x_pl.append(p if p.is_partial() else Replicate())
            i_pl.append(Replicate())
    # a partial x's gradient is the whole gradient on every rank
    grad = [Replicate() if p.is_partial() else p for p in x_pl]
    return local_call(lambda x, i: torch.gather(x, dim, i), [x, index], [x_pl, i_pl], x_pl,
                      [grad, i_pl])


def attend_local(attend, q, k, v, *, q_pos, k_pos, **kw):
    """``attend(q, k, v, q_pos=..., k_pos=..., **kw)`` for a multi-query
    call (prefill, training) on DTensors: each rank attends its own rows
    and KV heads on local tensors.  Attention is independent per row and
    per KV head; a rank needs its rows' whole key sequence, so a sharded
    sequence (a large cache's) is gathered, as are heads that q, k and v
    do not shard alike.  One call of the blocked attention's Python loop
    per rank instead of a DTensor dispatch per block.  Plain tensors, and
    single-query decode (attention over a sequence-sharded cache), call
    ``attend`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor) or q.shape[1] == 1:
        return attend(q, k, v, q_pos=q_pos, k_pos=k_pos, **kw)
    keep = [p if p in (Shard(0), Shard(2)) and k.placements[i] == p == v.placements[i]
            else Replicate() for i, p in enumerate(q.placements)]
    # positions are (T,), whole on every rank, or (B, T), split by rows as q is
    rows = [p if p == Shard(0) else Replicate() for p in keep]
    names = [n for n, t in (("q_pos", q_pos), ("k_pos", k_pos)) if t is not None]
    pos = [t for t in (q_pos, k_pos) if t is not None]

    def body(q, k, v, *pos):
        return attend(q, k, v, **{"q_pos": None, "k_pos": None, **dict(zip(names, pos))}, **kw)

    return local_call(body, [q, k, v, *pos],
                      [keep] * 3 + [rows if t.ndim == 2 else [Replicate()] * len(keep)
                                    for t in pos], keep)


def experts_local(ffn, params: dict, cfg, de):
    """``ffn(params, cfg, de)`` (the MoE experts, ``de`` (B, E, C, D)) for a
    DTensor ``de``: each rank runs its own rows through every expert on
    local tensors, the experts' weights gathered over the mesh dimensions
    that split the rows (FSDP) and split by the hidden dimension over the
    others where it divides (tensor parallel), so the output is a partial
    sum over those.  The weights' gradients are partial sums over the mesh
    dimensions that split the rows, ``de``'s over those that split the
    hidden dimension.  Plain tensors call ``ffn`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(de, DTensor):
        return ffn(params, cfg, de)
    mesh = de.device_mesh
    f = params["w_in"].shape[-1]
    rows = [p == Shard(0) for p in de.placements]
    tp = [not r and f % mesh.size(i) == 0 for i, r in enumerate(rows)]
    names = [n for n in ("w_in", "w_gate", "w_out") if n in params]
    x_pl = [Shard(0) if r else Replicate() for r in rows]
    w_pl = [[Shard(1 if n == "w_out" else 2) if t else Replicate() for t in tp] for n in names]
    x_grad = [Partial() if t else p for t, p in zip(tp, x_pl)]
    w_grad = [[Partial() if r else p for r, p in zip(rows, pl)] for pl in w_pl]

    def body(de, *ws):
        return ffn(dict(zip(names, ws)), cfg, de)

    return local_call(body, [de] + [params[n] for n in names], [x_pl] + w_pl,
                      [Shard(0) if r else Partial() if t else Replicate()
                       for r, t in zip(rows, tp)], [x_grad] + w_grad)


def active() -> bool:
    return _ACTIVE is not None
