"""Schedules: blocking + reorder + spatial unrolling + memory placement.

This is the normalized form that the paper's Halide schedule primitives lower
to (paper §4, Table 2):

    split / reorder      -> per-level tiling factors + per-level loop order
    in / compute_at      -> the memory-level structure (which buffer holds
                            which tile, introduced at which loop)
    unroll (+ systolic)  -> spatial assignment of loops to PE-array dims,
                            with replication = several loops on one dim
    accelerate           -> the scope (the whole nest here)

A `Schedule` fully determines the access counts at every memory level (see
reuse.py) and therefore energy/performance under a cost table (energy.py).
(The reference's `halide.py` front-end lowers to this; the port has no
copy of it yet.)

Level convention: index 0 is the innermost (RF next to the MAC), the last
level is off-chip DRAM/HBM.  The PE array sits between level 0 and level 1:
level-1 buffers feed the whole array; level-0 buffers are per-PE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.core.loopnest import LoopNest


@dataclasses.dataclass(frozen=True)
class MemLevel:
    """One level of the storage hierarchy.

    capacity_bytes: None means unbounded (DRAM/HBM).
    bandwidth_words_per_cycle: words/cycle this level can deliver to its child
        (array-wide).  Used for the performance roofline.
    double_buffered: reserve 2x capacity to overlap fill with compute
        (paper Fig 5).
    """

    name: str
    capacity_bytes: int | None = None
    bandwidth_words_per_cycle: float = float("inf")
    double_buffered: bool = True
    # True for levels private to one PE (register files).  Per-PE levels must
    # form a prefix of the hierarchy; the PE array sits between the last
    # per-PE level and the first shared level.
    per_pe: bool = False


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Physical PE array: one entry per spatial dimension (1D or 2D)."""

    dims: tuple[int, ...]  # e.g. (16, 16)

    @property
    def num_pes(self) -> int:
        return math.prod(self.dims)


@dataclasses.dataclass(frozen=True)
class Schedule:
    nest: LoopNest
    levels: tuple[MemLevel, ...]
    # tiling[d] = per-level temporal factors, innermost (level 0) first.
    # product(tiling[d]) * spatial factor of d  must equal padded bound of d.
    tiling: Mapping[str, tuple[int, ...]]
    # order[l] = dims innermost-first at level l (all dims must appear once).
    order: tuple[tuple[str, ...], ...]
    array: ArraySpec = ArraySpec(dims=(1,))
    # spatial[a] = loops unrolled on array dim a, ordered nearest-first
    # (replication = len > 1, paper Fig 2/3).  (dim, factor) pairs.
    spatial: tuple[tuple[tuple[str, int], ...], ...] = ((),)
    word_bytes: int = 2  # 16-bit arithmetic throughout the paper (§5)

    # ---------------------------------------------------------- validation --
    def __post_init__(self):
        L = len(self.levels)
        flags = [lvl.per_pe for lvl in self.levels]
        if any(flags[i] and not all(flags[:i]) for i in range(L)):
            raise ValueError("per-PE levels must form a prefix of the hierarchy")
        if len(self.order) != L:
            raise ValueError(f"need one loop order per level ({L}), got {len(self.order)}")
        if len(self.spatial) != len(self.array.dims):
            raise ValueError("one spatial assignment per array dim required")
        for d in self.nest.dims:
            if d not in self.tiling:
                raise ValueError(f"dim {d} missing from tiling")
            if len(self.tiling[d]) != L:
                raise ValueError(f"tiling[{d}] must have {L} factors")
        for l, o in enumerate(self.order):
            if sorted(o) != sorted(self.nest.dims):
                raise ValueError(f"order at level {l} must be a permutation of dims")
        for a, assigns in enumerate(self.spatial):
            cap = self.array.dims[a]
            used = math.prod(f for _, f in assigns) if assigns else 1
            if used > cap:
                raise ValueError(
                    f"spatial dim {a}: {used} PEs assigned but only {cap} available"
                )
        for d in self.nest.dims:
            total = math.prod(self.tiling[d]) * self.spatial_factor(d)
            if total < self.nest.bounds[d]:
                raise ValueError(
                    f"dim {d}: tiling*spatial={total} < bound {self.nest.bounds[d]}"
                )

    # ------------------------------------------------------------- queries --
    @property
    def array_boundary(self) -> int:
        """Index of the first shared (non-per-PE) level: the PE array sits
        between levels `array_boundary - 1` and `array_boundary`.  If no level
        is marked per-PE, the array feeds straight from level 0 (boundary 0),
        i.e. level 0 is shared."""
        for i, lvl in enumerate(self.levels):
            if not lvl.per_pe:
                return i
        return len(self.levels)

    def used_pes(self) -> int:
        return math.prod(
            math.prod(f for _, f in assigns) if assigns else 1
            for assigns in self.spatial
        )

    def spatial_factor(self, dim: str) -> int:
        f = 1
        for assigns in self.spatial:
            for d, s in assigns:
                if d == dim:
                    f *= s
        return f

    def padded_bound(self, dim: str) -> int:
        return math.prod(self.tiling[dim]) * self.spatial_factor(dim)

    def padded_macs(self) -> int:
        return math.prod(self.padded_bound(d) for d in self.nest.dims)

    def temporal_trips(self) -> int:
        """Total temporal iterations = padded MACs / PEs actually used."""
        return math.prod(
            math.prod(self.tiling[d]) for d in self.nest.dims
        )

    def utilization(self) -> float:
        """Active-PE ratio x padding efficiency (paper Fig 9)."""
        pad = self.nest.macs() / self.padded_macs()
        return (self.used_pes() / self.array.num_pes) * pad

    def cum_tile(self, level: int, include_spatial: bool) -> dict[str, int]:
        """Iteration-space tile covered by levels 0..level (inclusive)."""
        tile: dict[str, int] = {}
        for d in self.nest.dims:
            t = math.prod(self.tiling[d][: level + 1]) if level >= 0 else 1
            if include_spatial:
                t *= self.spatial_factor(d)
            tile[d] = t
        return tile

    def child_tile(self, level: int) -> dict[str, int]:
        """Tile streamed between `level` and its child (see module docstring).

        child of level 0 = one MAC operand; child of the array-boundary level
        = the array-wide union of the per-PE tiles below it; child of any
        other level l = the level l-1 tile.
        """
        if level == 0:
            return {d: 1 for d in self.nest.dims}
        return self.cum_tile(level - 1, include_spatial=(level > self.array_boundary - 1))

    def loops_at_and_above(self, level: int) -> list[tuple[str, int]]:
        """Temporal loops from the innermost loop of `level` to the top,
        innermost-first: (dim, trip) with trip = tiling factor at that level."""
        out: list[tuple[str, int]] = []
        for l in range(level, len(self.levels)):
            for d in self.order[l]:
                out.append((d, self.tiling[d][l]))
        return out
