"""Batched NumPy cost-model engine: reuse.py + energy.py over many schedules.

The scalar pair `analyze()` (reuse.py) and `evaluate()` (energy.py) walk one
schedule at a time with Python dicts — fine as an oracle, hopeless as the
inner loop of a mapping search that prices hundreds of thousands of
(hardware x layer x tile x order) candidates.  This module evaluates the same
model over a *batch* of candidates at once:

  * tilings become an ``(n, L, D)`` int64 tensor (n candidates, L memory
    levels, D loop dims),
  * per-level loop orders become an ``(n, L, D)`` index tensor (innermost
    first, values index into ``nest.dims``),
  * reloads / stationarity / footprints / hops become vectorized reductions
    over those tensors, and the per-level energies a single dot with the
    ``CostTable`` vector.

All candidates in a batch share the nest, the memory hierarchy, the PE array
and the spatial (dataflow) assignment — exactly the shape of a blocking
search frontier.  Counts are computed in int64 and energies in float64 with
the *same operation ordering* as the scalar path, so results are bit-identical
to `evaluate()`; the reference's `tests/test_costmodel.py` enforces this
differentially on randomized schedules.  The scalar path remains the
semantic oracle (see `reuse.stationarity` / `reuse.reloads` for the model
definition).

The port's copy of the reference's ``core/costmodel.py``, held to the
reference's search results bit for bit by ``tests/test_torch_core.py``.  The
hierarchy sweeps, ABFT and decode-gather pricing of the reference's module
wait for the port's DSE and serve planner.

Schedules whose counts could overflow int64 (or lose float exactness past
2**53 in the hop accumulation) raise :class:`BatchOverflowError` at
construction; callers fall back to the scalar oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.energy import CostTable
from repro_torch.core.loopnest import LoopNest
from repro_torch.core.schedule import ArraySpec, MemLevel

# Rows per internal chunk: bounds peak memory of the (n, L*D) intermediates.
_CHUNK = 32768

# Safety margin for int64 count arithmetic (and exact float accumulation).
_MAX_COUNT = 2 ** 52


class BatchOverflowError(ValueError):
    """Counts for this nest/hierarchy may exceed exact integer range."""


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """Vectorized analogue of (AccessCounts, Report) for a batch.

    Index [i] of every array corresponds to candidate i of the batch.
    """

    energy_pj: np.ndarray       # (n,)   float64
    level_totals: np.ndarray    # (n, L) int64, reads+writes served by level
    reads: np.ndarray           # (n, L, T) int64, T = len(nest.tensors)
    writes: np.ndarray          # (n, L, T) int64
    hops: np.ndarray            # (n, T) float64 hop-weighted word transfers
    cycles: np.ndarray          # (n,)   float64
    utilization: np.ndarray     # (n,)   float64
    macs: int


class BatchedCostModel:
    """Prices batches of candidate schedules sharing one (nest, hw, dataflow).

    Parameters mirror `Schedule` minus the per-candidate tiling/order, which
    arrive as arrays at evaluation time.
    """

    def __init__(
        self,
        nest: LoopNest,
        levels: Sequence[MemLevel],
        array: ArraySpec | None = None,
        spatial: tuple = ((),),
        table: CostTable | None = None,
        word_bytes: int = 2,
    ):
        self.nest = nest
        self.levels = tuple(levels)
        self.array = array or ArraySpec(dims=tuple(1 for _ in spatial))
        self.spatial = tuple(tuple(a) for a in spatial)
        self.word_bytes = word_bytes
        self.table = table or CostTable.for_levels(self.levels)

        self.dims = tuple(nest.dims)
        self.D = len(self.dims)
        self.L = len(self.levels)
        self.dim_index = {d: i for i, d in enumerate(self.dims)}
        self.tensors = nest.tensors
        self.T = len(self.tensors)
        self.out_i = next(i for i, t in enumerate(self.tensors) if t.output)

        flags = [lvl.per_pe for lvl in self.levels]
        if any(flags[i] and not all(flags[:i]) for i in range(self.L)):
            raise ValueError("per-PE levels must form a prefix of the hierarchy")
        self.boundary = next(
            (i for i, lvl in enumerate(self.levels) if not lvl.per_pe), self.L
        )
        self.blevel = min(max(self.boundary, 1), self.L - 1)

        sp_factor = {d: 1 for d in self.dims}
        used_pes = 1
        red_spatial = 1
        for assigns in self.spatial:
            for d, s in assigns:
                sp_factor[d] *= s
                used_pes *= s
                if d in nest.reduction_dims:
                    red_spatial *= s
        self.sp = np.array([sp_factor[d] for d in self.dims], dtype=np.int64)
        self.used_pes = used_pes
        self.red_spatial = red_spatial

        # per-tensor structure: relevance vector + coupled/uncoupled split
        self.rel_vecs: list[np.ndarray] = []
        self.coupled: list[list[tuple[int, int, int]]] = []
        self.plain: list[list[int]] = []
        for t in self.tensors:
            rel = t.relevant
            self.rel_vecs.append(
                np.array([d in rel for d in self.dims], dtype=bool)
            )
            pairs = []
            handled: set[str] = set()
            for base, (filt, stride) in t.coupled.items():
                pairs.append((self.dim_index[base], self.dim_index[filt], stride))
                handled.add(base)
                handled.add(filt)
            self.coupled.append(pairs)
            self.plain.append(
                [self.dim_index[d] for d in t.dims if d not in handled]
            )

        self.pj = tuple(self.table.level_pj)
        if len(self.pj) != self.L:
            raise ValueError("cost table does not match hierarchy depth")
        self.macs = nest.macs()

        # overflow guard: largest hop distance term and the padded-MAC limit
        # below which every count the model produces stays in exact range
        hop_scale = 1
        for assigns in self.spatial:
            dist = 1
            for _, s in assigns:
                hop_scale = max(hop_scale, (s - 1) * dist)
                dist *= s
        # 2**D covers sliding-window halo inflation of tile_elems
        self._max_padded_macs = _MAX_COUNT / (
            self.used_pes * hop_scale * (2 ** self.D)
        )
        self.check_range(
            {
                d: math.ceil(nest.bounds[d] / int(self.sp[j]))
                for j, d in enumerate(self.dims)
            }
        )

    # -------------------------------------------------------------- helpers --

    def _elems(self, t_i: int, tile: np.ndarray) -> np.ndarray:
        """Vectorized TensorRef.tile_elems over a (n, D) tile array."""
        n = np.ones(tile.shape[0], dtype=np.int64)
        for base, filt, stride in self.coupled[t_i]:
            n = n * (stride * (tile[:, base] - 1) + tile[:, filt])
        for d in self.plain[t_i]:
            n = n * tile[:, d]
        return n

    def check_range(self, full_rem: dict[str, int]) -> None:
        """Raise BatchOverflowError if counts could exceed exact range.

        `full_rem` is the per-dim product of all temporal factors (constant
        across a search frontier: factors always multiply to the padded
        bound).  The coarse bound dominates every count and hop term the
        model produces.  Called automatically at construction with the
        nest's own bounds; `_counts` re-checks each batch's actual padded
        sizes, so tilings that pad beyond the nest bounds are caught too.
        """
        padded = 1
        for d in self.dims:
            padded *= full_rem[d] * int(self.sp[self.dim_index[d]])
        if padded > self._max_padded_macs:
            raise BatchOverflowError(
                f"counts for nest {self.nest.name} may overflow the batched "
                "engine; use the scalar oracle"
            )

    # ------------------------------------------------------------- pricing --

    def evaluate(self, tilings: np.ndarray, orders: np.ndarray) -> BatchReport:
        """Full batched analyze()+evaluate(): energies, counts, cycles."""
        tilings = np.asarray(tilings, dtype=np.int64)
        orders = np.asarray(orders, dtype=np.int64)
        n = tilings.shape[0]
        parts = [
            self._evaluate_chunk(tilings[i : i + _CHUNK], orders[i : i + _CHUNK])
            for i in range(0, n, _CHUNK)
        ]
        if not parts:
            z = np.zeros(0)
            zi = np.zeros((0, self.L), np.int64)
            return BatchReport(z, zi, np.zeros((0, self.L, self.T), np.int64),
                               np.zeros((0, self.L, self.T), np.int64),
                               np.zeros((0, self.T)), z, z, self.macs)
        if len(parts) == 1:
            return parts[0]
        return BatchReport(
            *(np.concatenate([getattr(p, f.name) for p in parts])
              for f in dataclasses.fields(BatchReport)[:-1]),
            self.macs,
        )

    def energy(self, tilings: np.ndarray, orders: np.ndarray) -> np.ndarray:
        return self.evaluate(tilings, orders).energy_pj

    def _counts(self, til: np.ndarray, orders: np.ndarray):
        """Core vectorized access-count model for one chunk.

        Returns (reads, writes, cum, suffix) with reads/writes (n, L, T).
        """
        n = til.shape[0]
        L, D, T = self.L, self.D, self.T
        P = L * D

        # trips of the flattened temporal loop stack, innermost first
        trips = np.take_along_axis(til, orders, axis=2).reshape(n, P)
        # suffix[p] = product of trips at positions >= p  (suffix[P] = 1)
        suffix = np.ones((n, P + 1), dtype=np.int64)
        suffix[:, :-1] = np.cumprod(trips[:, ::-1], axis=1)[:, ::-1]

        # guard the whole chunk in float (immune to int64 wraparound)
        padded_f = (til.astype(np.float64).prod(axis=1) * self.sp).prod(axis=1)
        if padded_f.max(initial=0.0) > self._max_padded_macs:
            raise BatchOverflowError(
                f"tilings for nest {self.nest.name} exceed the batched "
                "engine's exact integer range; use the scalar oracle"
            )

        cum = np.cumprod(til, axis=1)          # (n, L, D) tiles through level l
        padded = cum[:, -1, :] * self.sp       # (n, D)

        # child tile streamed into each level (see Schedule.child_tile)
        childs: list[np.ndarray] = []
        for l in range(L):
            if l == 0:
                childs.append(np.ones((n, D), dtype=np.int64))
            else:
                c = cum[:, l - 1, :]
                if l >= self.boundary:
                    c = c * self.sp
                childs.append(c)

        total_out = self._elems(self.out_i, padded)
        reads = np.zeros((n, L, T), dtype=np.int64)
        writes = np.zeros((n, L, T), dtype=np.int64)
        for t_i, t in enumerate(self.tensors):
            relpos = self.rel_vecs[t_i][orders].reshape(n, P)
            brk = np.cumsum(relpos & (trips > 1), axis=1)  # inclusive count
            for l in range(L):
                l0 = l * D
                base = brk[:, l0] - (relpos[:, l0] & (trips[:, l0] > 1))
                keep = (brk[:, l0:] - base[:, None]) == 0
                stat = np.where(keep, trips[:, l0:], 1).prod(axis=1)
                reloads = suffix[:, l0] // stat
                mult = self.used_pes if l < max(self.boundary, 1) else 1
                acc = reloads * self._elems(t_i, childs[l]) * mult
                if t.output:
                    first = total_out * (
                        self.red_spatial if l < max(self.boundary, 1) else 1
                    )
                    writes[:, l, t_i] = acc
                    reads[:, l, t_i] = np.maximum(0, acc - first)
                else:
                    reads[:, l, t_i] = acc
        return reads, writes, padded, suffix

    def _hops(self, reads: np.ndarray, writes: np.ndarray) -> np.ndarray:
        """Hop-weighted inter-PE transfers, same accumulation order as
        reuse.analyze (exact-float: integer terms below 2**53)."""
        n = reads.shape[0]
        hops = np.zeros((n, self.T))
        for t_i, t in enumerate(self.tensors):
            rel = t.relevant
            h = np.zeros(n)
            for assigns in self.spatial:
                dist = 1
                for dim, s in assigns:
                    if s > 1:
                        irrelevant = dim not in rel
                        reduction = t.output and dim in self.nest.reduction_dims
                        if irrelevant or reduction:
                            base = (
                                reads[:, self.blevel, t_i]
                                if not t.output
                                else writes[:, self.blevel, t_i]
                            )
                            h = h + base * ((s - 1) * dist)
                    dist *= s
            hops[:, t_i] = h
        return hops

    def _evaluate_chunk(self, til, orders) -> BatchReport:
        reads, writes, padded, suffix = self._counts(til, orders)
        hops = self._hops(reads, writes)
        n = til.shape[0]

        level_totals = reads.sum(axis=2) + writes.sum(axis=2)  # (n, L)
        total = np.zeros(n)
        for l in range(self.L):
            total = total + level_totals[:, l] * self.pj[l]
        hsum = np.zeros(n)
        for t_i in range(self.T):
            hsum = hsum + hops[:, t_i]
        total = total + (self.macs * self.table.mac_pj + hsum * self.table.hop_pj)

        cycles = suffix[:, 0].astype(np.float64)  # temporal trips
        for l, lvl in enumerate(self.levels):
            bw = lvl.bandwidth_words_per_cycle
            if math.isfinite(bw):
                cycles = np.maximum(cycles, level_totals[:, l] / bw)

        padded_macs = padded.prod(axis=1)
        util = (self.used_pes / self.array.num_pes) * (self.macs / padded_macs)

        return BatchReport(
            energy_pj=total,
            level_totals=level_totals,
            reads=reads,
            writes=writes,
            hops=hops,
            cycles=cycles,
            utilization=util,
            macs=self.macs,
        )

    def level_energy(
        self, tilings: np.ndarray, orders: np.ndarray, level: int
    ) -> np.ndarray:
        """Energy of accesses served BY `level` (+ array hops when `level`
        feeds the PE array) — the batched form of blocking._level_energy."""
        tilings = np.asarray(tilings, dtype=np.int64)
        orders = np.asarray(orders, dtype=np.int64)
        n = tilings.shape[0]
        out = np.empty(n)
        for i in range(0, n, _CHUNK):
            til, odr = tilings[i : i + _CHUNK], orders[i : i + _CHUNK]
            reads, writes, _, _ = self._counts(til, odr)
            lt = reads[:, level, :].sum(axis=1) + writes[:, level, :].sum(axis=1)
            e = lt * self.pj[level]
            if level == self.blevel:
                hops = self._hops(reads, writes)
                hsum = np.zeros(til.shape[0])
                for t_i in range(self.T):
                    hsum = hsum + hops[:, t_i]
                e = e + hsum * self.table.hop_pj
            out[i : i + len(e)] = e
        return out
