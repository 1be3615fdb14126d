"""Halide-style scheduling front-end (paper §4, Listing 1).

The paper expresses accelerators as Halide schedules:

    output.split(x, xo, xi, 8).split(y, yo, yi, 8)
          .reorder(xi, yi, r.z, r.y, r.x)
          .in_(ibuf).compute_at(output, xo)
          .unroll(xi, dim=0).systolic()
          .accelerate()

This module provides that fluent vocabulary and LOWERS it to the normalized
`Schedule` (core/schedule.py) the analytical model consumes - the same
split between user-facing language and compiler IR the paper builds.

Primitives (Table 2):
    split(dim, factor)        loop blocking: peel `factor` into the current
                              (innermost-unfinished) memory level
    at_level(name)            move the "cursor": subsequent splits define
                              the tile of this level
    reorder(*dims)            loop order (innermost first) at the cursor level
    store(name, capacity)     declare a memory level (in/compute_at fused:
                              buffers in this system always sit at the loop
                              that the level's tile implies)
    unroll(dim, factor, axis) spatial unrolling onto PE-array axis
                              (replication = repeated unroll on one axis)
    systolic()                tag the array as systolic (affects the hop
                              model's labeling only; energy model per §5)
    accelerate()              finalize -> Schedule

The port's copy of the reference's ``core/halide.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.loopnest import LoopNest
from repro_torch.core.schedule import ArraySpec, MemLevel, Schedule


class HalideSchedule:
    def __init__(self, nest: LoopNest, array_dims: Sequence[int] = (1,)):
        self.nest = nest
        self.array = ArraySpec(dims=tuple(array_dims))
        self._levels: list[MemLevel] = []
        self._factors: list[dict[str, int]] = []   # per level
        self._orders: list[tuple[str, ...] | None] = []
        self._spatial: list[list[tuple[str, int]]] = [
            [] for _ in self.array.dims
        ]
        self._systolic = False
        self._cursor = -1

    # ------------------------------------------------------------ memory --
    def store(self, name: str, capacity_bytes: int | None = None,
              per_pe: bool = False, double_buffered: bool = True
              ) -> "HalideSchedule":
        """Declare the next memory level outward (RF first, DRAM last)."""
        self._levels.append(
            MemLevel(name, capacity_bytes, double_buffered=double_buffered,
                     per_pe=per_pe)
        )
        self._factors.append({})
        self._orders.append(None)
        self._cursor = len(self._levels) - 1
        return self

    def at_level(self, name: str) -> "HalideSchedule":
        self._cursor = next(
            i for i, l in enumerate(self._levels) if l.name == name
        )
        return self

    # ------------------------------------------------------------- loops --
    def split(self, dim: str, factor: int) -> "HalideSchedule":
        """Assign `factor` iterations of `dim` to the cursor level's tile."""
        assert self._cursor >= 0, "store() a level before split()"
        f = self._factors[self._cursor]
        f[dim] = f.get(dim, 1) * factor
        return self

    def reorder(self, *dims: str) -> "HalideSchedule":
        """Loop order at the cursor level, innermost first."""
        rest = [d for d in self.nest.dims if d not in dims]
        self._orders[self._cursor] = tuple(dims) + tuple(rest)
        return self

    def unroll(self, dim: str, factor: int, axis: int = 0) -> "HalideSchedule":
        """Spatially unroll `dim` by `factor` PEs on array axis `axis`."""
        self._spatial[axis].append((dim, factor))
        return self

    def systolic(self) -> "HalideSchedule":
        self._systolic = True
        return self

    # ---------------------------------------------------------- finalize --
    def accelerate(self) -> Schedule:
        """Lower to the normalized Schedule; the outermost level absorbs
        whatever iterations remain (the DRAM-resident loops)."""
        assert self._levels, "no memory levels declared"
        L = len(self._levels)
        sp = {d: 1 for d in self.nest.dims}
        for assigns in self._spatial:
            for d, f in assigns:
                sp[d] *= f
        tiling: dict[str, tuple[int, ...]] = {}
        for d in self.nest.dims:
            per = [self._factors[l].get(d, 1) for l in range(L)]
            inner = math.prod(per[:-1])
            need = math.ceil(self.nest.bounds[d] / sp[d])
            top = max(per[-1], math.ceil(need / inner))
            tiling[d] = tuple(per[:-1] + [top])
        orders = tuple(
            o if o is not None else tuple(self.nest.dims)
            for o in self._orders
        )
        return Schedule(
            nest=self.nest,
            levels=tuple(self._levels),
            tiling=tiling,
            order=orders,
            array=self.array,
            spatial=tuple(tuple(s) for s in self._spatial),
        )


def listing1_example(nest: LoopNest) -> Schedule:
    """The paper's Listing 1 schedule, in this front-end: split x and y by
    8 into a local buffer, reorder, and unroll 4 PEs systolically."""
    return (
        HalideSchedule(nest, array_dims=(4,))
        .store("RF", 512, per_pe=True, double_buffered=False)
        .store("ibuf", 128 * 1024)
        .split("X", 8).split("Y", 8)
        .reorder("FX", "FY", "C", "X", "Y")
        .store("DRAM", None)
        .at_level("RF")
        .unroll("X", 4, axis=0)
        .systolic()
        .accelerate()
    )
