"""Memory-resource-allocation design-space exploration (paper §6.3, Fig 10-12).

The paper's headline quantitative result is that re-allocating the *memory*
resources of a fixed PE array — register-file bytes vs on-chip buffer bytes,
one- vs two-level register hierarchies — changes total energy by up to 4.2x
(CNNs), 1.6x (LSTMs) and 1.8x (MLPs) at constant throughput:

  * Fig 10: energy of the best blocking as a function of per-level buffer
    capacity — each capacity point requires a full blocking search, so the
    sweep is a (hierarchy x layer x tiling x order) product space;
  * Fig 11: one- vs two-level register hierarchies at iso total capacity;
  * Fig 12: the iso-throughput resource-allocation frontier across whole
    networks, from which the 4.2x/1.6x/1.8x ratios are read.

This module is that sweep as a subsystem.  The engine exploits the central
factoring of the analytical model: access *counts* depend only on the
schedule (tiling/order/spatial) and the hierarchy's structure (level count,
per-PE prefix) — never on level capacities — while capacities enter only
through per-access energies and feasibility.  So an iso-structure family of
hierarchies shares one candidate frontier (enumerated against the family's
most permissive capacities) and one counts pass; each member then costs one
``level_totals @ level_pj`` contraction plus a vectorized footprint mask
(costmodel.BatchedCostModel.evaluate_hierarchies).  Pricing H hierarchies is
therefore ~H times cheaper than running H blocking searches, which is what
`optimize_network` does sequentially.

Results accumulate into Pareto frontiers over (energy, cycles) with
incremental dominance pruning, and every priced (nest x hierarchy-family)
block can be persisted to an on-disk JSON cache so interrupted or repeated
sweeps are incremental.

Multi-network sweeps fan out over a ``concurrent.futures`` process pool
(``workers > 0``): each distinct nest's frontier pricing is an independent
task.

The port's copy of the reference's ``core/dse.py``; its pool's children
import ``repro_torch.core``, which loads no torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

import numpy as np

from repro_torch.core.blocking import enumerate_frontier
from repro_torch.core.costmodel import BatchedCostModel
from repro_torch.core.energy import CostTable
from repro_torch.core.jsonstore import atomic_write_json, load_json_dict
from repro_torch.core.loopnest import LoopNest
from repro_torch.core.optimizer import HardwareConfig, candidate_hierarchies, ck_dataflow
from repro_torch.core.schedule import ArraySpec, MemLevel

WORD_BYTES = 2  # 16-bit arithmetic throughout the paper (§5)


# ------------------------------------------------------------------ points --


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One resource allocation priced over a whole network."""

    hw: HardwareConfig
    energy_pj: float
    cycles: float

    @property
    def edp(self) -> float:
        return self.energy_pj * self.cycles


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a dominates b: no worse in every objective, better in at least one."""
    return all(x <= y for x, y in zip(a, b)) and any(
        x < y for x, y in zip(a, b)
    )


def pareto_prune(
    points: Sequence[DesignPoint],
    keys: tuple[str, ...] = ("energy_pj", "cycles"),
) -> list[DesignPoint]:
    """Incremental non-dominated frontier (minimization in every key).

    Points are folded in one at a time: a new point is discarded if any
    frontier member dominates it, otherwise it evicts the members it
    dominates.  Ties (equal vectors) are all kept — never drops a
    non-dominated point (property-tested against the brute-force filter in
    the reference's tests/test_dse.py).
    """
    frontier: list[DesignPoint] = []
    vecs: list[tuple[float, ...]] = []
    for p in points:
        v = tuple(getattr(p, k) for k in keys)
        if any(dominates(q, v) for q in vecs):
            continue
        keep = [i for i, q in enumerate(vecs) if not dominates(v, q)]
        frontier = [frontier[i] for i in keep] + [p]
        vecs = [vecs[i] for i in keep] + [v]
    return frontier


# Relative tolerance for the iso-throughput cycle comparison.  The limit is
# the float product ``baseline.cycles * slack``, and a point whose cycles
# were computed through a different sequence of float ops can land one ulp
# above a mathematically-equal limit — most visibly the baseline itself,
# which must always qualify at slack=1.0.
ISO_CYCLES_RTOL = 1e-9


def best_at_iso_throughput(
    points: Sequence[DesignPoint],
    baseline: DesignPoint,
    slack: float = 1.0,
) -> DesignPoint:
    """Lowest-energy point whose cycle count stays within ``slack`` x the
    baseline's — the paper's "keeping throughput constant" constraint (the
    PE array is fixed across the sweep, so cycles differ only through the
    bandwidth roofline).

    The comparison carries a relative epsilon (``ISO_CYCLES_RTOL``) so float
    ties — ``cycles == baseline.cycles * slack`` up to rounding — qualify;
    without it the baseline itself can fail its own constraint at
    ``slack=1.0`` when the product rounds below ``baseline.cycles``.  When
    no point qualifies, the error reports the nearest miss and the slack
    that would admit it instead of discarding the sweep's context."""
    if not points:
        raise ValueError(
            "no design points to choose from (empty sweep — every "
            "candidate hierarchy was infeasible or unpriceable)"
        )
    limit = baseline.cycles * slack
    ok = [p for p in points if p.cycles <= limit * (1.0 + ISO_CYCLES_RTOL)]
    if not ok:
        nearest = min(points, key=lambda p: p.cycles)
        need = (
            nearest.cycles / baseline.cycles
            if baseline.cycles > 0
            else math.inf
        )
        raise ValueError(
            f"no design point meets the throughput constraint: limit "
            f"{limit:.6g} cycles ({slack:g}x baseline {baseline.cycles:.6g});"
            f" nearest miss is {nearest.hw.name!r} at {nearest.cycles:.6g} "
            f"cycles ({nearest.cycles - limit:.6g} over — needs slack >= "
            f"{need:.9g}) out of {len(points)} swept points"
        )
    return min(ok, key=lambda p: p.energy_pj)


# ------------------------------------------------------------------- cache --


class SweepCache:
    """On-disk JSON store of priced (nest x hierarchy-family) blocks.

    Keys hash the nest structure, the family's hierarchy descriptors and the
    enumeration parameters, so re-runs of an interrupted or extended sweep
    only price new blocks.  Writes are atomic (tmp + rename) and
    **merge-on-write**: a flush re-reads the file and folds this process's
    new entries into whatever other sweep processes have published since we
    loaded it (the same read-merge-replace idiom as ``mapper._store_tile``),
    so concurrent sweeps sharing a cache file never clobber each other's
    priced blocks.

    Writes are also batched: ``put`` only marks the entry dirty, and the
    file is rewritten once per ``flush_every`` new entries plus a final
    :meth:`flush` at the end of the sweep — not once per put, which made a
    long sweep's cache I/O O(N^2) in the number of blocks.  An interrupted
    sweep therefore loses at most the last ``flush_every - 1`` priced
    blocks, never the merged prefix."""

    def __init__(self, path: str | None, flush_every: int = 16):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1: {flush_every}")
        self.path = path
        self.flush_every = flush_every
        self._dirty: dict[str, dict] = {}
        self._data: dict[str, dict] = {}
        if path and os.path.exists(path):
            self._data = load_json_dict(path)

    def get(self, key: str) -> dict | None:
        return self._data.get(key)

    def put(self, key: str, value: dict) -> None:
        self._data[key] = value
        self._dirty[key] = value
        if self.path and len(self._dirty) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Publish dirty entries: re-read the file, merge our new entries
        over it, write atomically.  Entries published by other processes
        since load are both preserved on disk and folded into this
        instance, so later ``get``s see them too.  Best-effort like the
        tile cache: an unwritable path keeps the in-memory results."""
        if not self.path or not self._dirty:
            return
        on_disk = load_json_dict(self.path)
        on_disk.update(self._dirty)
        try:
            atomic_write_json(self.path, on_disk)
        except OSError:
            return  # keep entries dirty; a later flush may succeed
        self._data = {**on_disk, **self._data}
        self._dirty = {}


# Bump whenever the enumeration or cost-model arithmetic changes, so stale
# priced blocks from an older algorithm are never served from a cache file.
_SWEEP_CACHE_SCHEMA = "v1"


def _block_key(
    nest: LoopNest,
    array: ArraySpec,
    hws: Sequence[HardwareConfig],
    max_choices_per_level: int,
    max_frontier: int,
) -> str:
    desc = repr(
        (
            _SWEEP_CACHE_SCHEMA,
            nest.key(),
            array.dims,
            tuple(
                (hw.rf_bytes, hw.buffer_bytes, hw.dram_bandwidth_words_per_cycle)
                for hw in hws
            ),
            max_choices_per_level,
            max_frontier,
        )
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:32]


# ------------------------------------------------------------------- sweep --


def _family_signature(hw: HardwareConfig) -> tuple:
    """Hierarchies with equal signatures share level structure (count +
    per-PE prefix + double-buffer flags) and hence share access counts."""
    return (len(hw.rf_bytes), len(hw.buffer_bytes))


def _family_levels(hws: Sequence[HardwareConfig]) -> tuple[MemLevel, ...]:
    """The family's most permissive hierarchy: per-level max capacity (the
    enumeration superset; members mask their own feasibility)."""
    mats = [hw.levels() for hw in hws]
    out = []
    for l, lvl in enumerate(mats[0]):
        caps = [m[l].capacity_bytes for m in mats]
        cap = None if any(c is None for c in caps) else max(caps)
        out.append(dataclasses.replace(lvl, capacity_bytes=cap))
    return tuple(out)


def _price_nest_block(
    nest: LoopNest,
    array: ArraySpec,
    hws: Sequence[HardwareConfig],
    max_choices_per_level: int,
    max_frontier: int,
) -> dict:
    """Price one nest against one iso-structure hierarchy family.

    Returns per-hierarchy best energy/cycles (+inf where no candidate fits)
    as plain lists so results are JSON-cacheable and pool-transportable.
    A family whose most permissive capacities fit no blocking at all, or a
    nest whose counts overflow the batched engine's exact range
    (BatchOverflowError), yields all-infeasible rows — mirroring how
    `optimize_network` skips hierarchies it cannot price, instead of
    aborting the whole sweep.
    """
    df = ck_dataflow(nest, array)
    levels_max = _family_levels(hws)
    try:
        til, odr = enumerate_frontier(
            nest, levels_max, array, df,
            max_choices_per_level=max_choices_per_level,
            max_frontier=max_frontier,
        )
        cm = BatchedCostModel(
            nest, levels_max, array=array, spatial=df.assigns,
            table=CostTable.for_levels(levels_max),
        )
    except ValueError:  # includes BatchOverflowError
        return {
            "energy_pj": [math.inf] * len(hws),
            "cycles": [math.inf] * len(hws),
            "n_candidates": 0,
        }
    tables = [CostTable.for_levels(hw.levels()) for hw in hws]
    bandwidths = np.array(
        [
            [lvl.bandwidth_words_per_cycle for lvl in hw.levels()]
            for hw in hws
        ]
    )
    rep = cm.evaluate_hierarchies(til, odr, tables, bandwidths=bandwidths)
    foot = rep.footprint_words * WORD_BYTES  # (n, L) bytes, un-doubled
    energies, cycles = [], []
    for h, hw in enumerate(hws):
        feasible = np.ones(til.shape[0], dtype=bool)
        for l, lvl in enumerate(hw.levels()):
            if lvl.capacity_bytes is None:
                continue
            need = foot[:, l] * (2 if lvl.double_buffered else 1)
            feasible &= need <= lvl.capacity_bytes
        if not feasible.any():
            energies.append(math.inf)
            cycles.append(math.inf)
            continue
        e = np.where(feasible, rep.energy_pj[h], math.inf)
        j = int(np.argmin(e))
        energies.append(float(e[j]))
        cycles.append(float(rep.cycles[h, j]))
    return {"energy_pj": energies, "cycles": cycles, "n_candidates": int(til.shape[0])}


def _pool_task(args) -> tuple[str, dict]:
    key, nest, array, hws, mcpl, max_frontier = args
    return key, _price_nest_block(nest, array, hws, mcpl, max_frontier)


def sweep_allocations(
    layers: Sequence[LoopNest],
    array: ArraySpec,
    hw_candidates: Sequence[HardwareConfig] | None = None,
    *,
    two_level_rf: bool = False,
    max_choices_per_level: int = 48,
    max_frontier: int = 32768,
    workers: int = 0,
    cache: SweepCache | str | None = None,
) -> list[DesignPoint]:
    """Price every candidate resource allocation over a whole network.

    The hierarchy-batched engine: hierarchies are grouped into iso-structure
    families; each distinct layer shape is enumerated once per family and
    priced under every member in a single 4-D
    (hierarchies x candidates x levels x dims) call.  ``workers > 0`` fans
    the per-nest pricing tasks out over a process pool.  Pass ``cache`` (a
    path or SweepCache) to persist priced blocks; re-runs skip them.

    Returns one DesignPoint per feasible hierarchy (network totals), in the
    candidate order.  Feed the result to :func:`pareto_prune` /
    :func:`best_at_iso_throughput`.
    """
    hws = list(hw_candidates or candidate_hierarchies(array, two_level_rf))
    if isinstance(cache, str):
        cache = SweepCache(cache)

    # distinct nests with multiplicity (networks repeat layer shapes)
    shape_mult: dict[tuple, int] = {}
    shape_nest: dict[tuple, LoopNest] = {}
    for n in layers:
        k = n.key()
        shape_mult[k] = shape_mult.get(k, 0) + 1
        shape_nest.setdefault(k, n)

    families: dict[tuple, list[int]] = {}
    for i, hw in enumerate(hws):
        families.setdefault(_family_signature(hw), []).append(i)

    # assemble the (nest x family) block task list, consulting the cache
    tasks = []
    blocks: dict[tuple[tuple, tuple], dict] = {}
    for sig, idxs in families.items():
        fam = [hws[i] for i in idxs]
        for k, nest in shape_nest.items():
            ckey = _block_key(
                nest, array, fam, max_choices_per_level, max_frontier
            )
            got = cache.get(ckey) if cache else None
            if got is not None:
                blocks[(k, sig)] = got
            else:
                tasks.append(
                    (ckey, nest, array, fam, max_choices_per_level,
                     max_frontier)
                )

    if tasks:
        task_by_key = {t[0]: t for t in tasks}

        def record(ckey: str, blk: dict) -> None:
            # batched persistence: the cache flushes every `flush_every`
            # priced blocks (and once more below), so an interrupted sweep
            # resumes from all but the newest unflushed blocks
            _k, nest, _array, fam, _m, _mf = task_by_key[ckey]
            blocks[(nest.key(), _family_signature(fam[0]))] = blk
            if cache:
                cache.put(ckey, blk)

        try:
            if workers > 0:
                # spawn (not fork): callers may have torch or other thread
                # pools live in the parent, and fork() under threads can
                # deadlock
                with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"),
                ) as pool:
                    for ckey, blk in pool.map(_pool_task, tasks):
                        record(ckey, blk)
            else:
                for t in tasks:
                    record(*_pool_task(t))
        finally:
            if cache:
                cache.flush()

    points: list[DesignPoint] = []
    for sig, idxs in families.items():
        for pos, i in enumerate(idxs):
            total_e = 0.0
            total_c = 0.0
            for k, mult in shape_mult.items():
                blk = blocks[(k, sig)]
                total_e += blk["energy_pj"][pos] * mult
                total_c += blk["cycles"][pos] * mult
            if math.isfinite(total_e):
                points.append(
                    DesignPoint(hw=hws[i], energy_pj=total_e, cycles=total_c)
                )
    return points
