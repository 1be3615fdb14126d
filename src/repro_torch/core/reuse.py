"""Analytical per-level access-count model (paper §5).

The paper computes total memory energy as

    E = sum_i  #acc_i * e_i        with   #acc_i driven by per-level reuse

where the reuse at each level follows from the blocked/reordered loop nest.
We implement the standard order-dependent stationarity model (equivalent to
the Interstellar/Timeloop accounting):

  * The level-l buffer of tensor T holds exactly the child tile (the tile
    defined by all tiling factors at levels < l, plus the spatial factors
    once the boundary crosses the PE array).
  * Walking the temporal loops upward from the level-l boundary, the child
    tile stays resident ("stationary") across consecutive innermost loops
    that are IRRELEVANT to T (they do not change which elements are needed);
    the first relevant loop - and everything above it - forces a re-stream.

        reloads(T, l) = (prod of all temporal trips at levels >= l)
                        / (prod of trips of the consecutive innermost
                           irrelevant loops at the boundary)

        reads_at(l, T) = reloads(T, l) * |child tile of T at l|

  * The output tensor accumulates: every re-stream is a write of partial
    sums up the hierarchy plus a read back later, except each element's
    final value which is written once and never read back:

        writes_at(l, O) = updates(l)            (= reloads * child tile)
        reads_at(l, O)  = updates(l) - |O|      (clamped at 0)

  * Level 0 is the per-PE register file: its access count is the per-MAC
    operand traffic (the boundary is the MAC datapath itself).  The same
    formula applies with level -1 defined as a single element; innermost
    stationary operands (e.g. weight-stationary) are held in the operand
    latch and do not re-read the RF, which matches the paper's note that
    MAC activity factors are low under stationary patterns.

  * The PE array is the paper's extra "inter-PE" level: data whose spatially
    unrolled dims are irrelevant is multicast (hop energy per extra PE
    traversed); spatially unrolled reduction dims accumulate outputs across
    PEs (systolic drains).  Replicated loops mapped farther on the same
    physical dim pay proportionally longer hop distances (paper Fig 3).

Sliding-window (X/FX) halos enter through TensorRef.tile_elems; partial-tile
overlap reuse between adjacent tiles is not exploited, consistent with the
double-buffered hardware the paper generates.

Validated exactly against the tile-granular simulator in simulate.py
(tests/test_reuse_model.py, incl. hypothesis property sweeps).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.loopnest import TensorRef
from repro_torch.core.schedule import Schedule


@dataclasses.dataclass(frozen=True)
class AccessCounts:
    """Per-level, per-tensor access counts for one schedule."""

    # reads[l][tensor_name] = number of word reads served BY level l
    reads: tuple[Mapping[str, int], ...]
    writes: tuple[Mapping[str, int], ...]
    # array-level inter-PE hop-weighted word transfers per tensor
    hops: Mapping[str, float]
    macs: int
    utilization: float

    def level_total(self, level: int) -> int:
        return sum(self.reads[level].values()) + sum(self.writes[level].values())


def stationarity(schedule: Schedule, tensor: TensorRef, level: int) -> int:
    """Product of trips of consecutive innermost loops irrelevant to tensor,
    walking upward from the level-`level` boundary.  Trip-1 loops are
    transparent (they do not break stationarity).

    This (with `reloads`) is the semantic definition the batched engine in
    costmodel.py vectorizes; keep the two in lockstep.
    """
    rel = tensor.relevant
    reuse = 1
    for dim, trip in schedule.loops_at_and_above(level):
        if trip == 1:
            continue
        if dim in rel:
            break
        reuse *= trip
    return reuse


def reloads(schedule: Schedule, tensor: TensorRef, level: int) -> int:
    """Times the level-`level` child tile of `tensor` is re-streamed."""
    total = 1
    for _, trip in schedule.loops_at_and_above(level):
        total *= trip
    return total // stationarity(schedule, tensor, level)


def analyze(schedule: Schedule) -> AccessCounts:
    nest = schedule.nest
    L = len(schedule.levels)
    reads: list[dict[str, int]] = [dict() for _ in range(L)]
    writes: list[dict[str, int]] = [dict() for _ in range(L)]

    out = nest.output
    total_out = out.tile_elems(
        {d: schedule.padded_bound(d) for d in nest.dims}
    )
    boundary = schedule.array_boundary
    used_pes = schedule.used_pes()
    # Spatial unrolling of reduction dims means every PE produces partials for
    # the SAME outputs: per-PE first-touch totals multiply accordingly.
    red_spatial = 1
    for assigns in schedule.spatial:
        for d, s in assigns:
            if d in nest.reduction_dims:
                red_spatial *= s

    for l in range(L):
        child = schedule.child_tile(l)
        # Levels below the array boundary are per-PE: every active PE issues
        # its own accesses in parallel (so does the MAC datapath at level 0).
        mult = used_pes if l < max(boundary, 1) else 1
        for t in nest.tensors:
            child_elems = t.tile_elems(child)
            n = reloads(schedule, t, l) * child_elems * mult
            if t.output:
                first = total_out * (red_spatial if l < max(boundary, 1) else 1)
                writes[l][t.name] = n
                reads[l][t.name] = max(0, n - first)
            else:
                reads[l][t.name] = n
                writes[l][t.name] = 0

    # ----------------------------------------------------- array (inter-PE) --
    # Multicast: tensors for which a spatially unrolled dim is irrelevant are
    # broadcast along that physical dim.  Hop-weighted cost: a chain multicast
    # to s PEs costs (s - 1) hops per word; loops mapped farther out on the
    # same physical dim (replication) multiply the distance by the product of
    # nearer factors (paper Fig 3: inter-group hops cost more).
    hops: dict[str, float] = {}
    blevel = min(max(boundary, 1), L - 1)  # level feeding the array
    for t in nest.tensors:
        rel = t.relevant
        h = 0.0
        for assigns in schedule.spatial:
            dist_scale = 1  # product of nearer (left) factors on this dim
            for dim, s in assigns:
                if s > 1:
                    irrelevant = dim not in rel
                    reduction = t.output and dim in nest.reduction_dims
                    if irrelevant or reduction:
                        # words entering the array once fan out (inputs) or
                        # partial sums drain across PEs (outputs)
                        base = (
                            reads[blevel][t.name]
                            if not t.output
                            else writes[blevel][t.name]
                        )
                        h += base * (s - 1) * dist_scale
                dist_scale *= s
        hops[t.name] = h

    return AccessCounts(
        reads=tuple(reads),
        writes=tuple(writes),
        hops=hops,
        macs=nest.macs(),
        utilization=schedule.utilization(),
    )
