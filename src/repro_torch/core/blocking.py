"""Loop-blocking search (paper §3.1/§6.1): the dominant knob.

Given a hardware skeleton (memory levels + PE array) and a dataflow (spatial
unrolling), search per-level tiling factors and per-level loop orders that
minimize the analytical energy.  The paper performs "a conservatively pruned
search over the full design space guided by domain-specific knowledge"; we
implement the same style:

  * per-level tile enumeration over divisors with monotone capacity pruning,
  * stratified subsampling when a level's choice count explodes (keeps both
    buffer-filling and tiny tiles - the former usually win, Obs 1),
  * loop orders chosen greedily per level from stationarity templates
    (irrelevant-dims-innermost per tensor) or exhaustive permutations when
    few dims are active.

The port's copy of the reference's ``core/blocking.py``: ``search_blocking``
(the top-down beam search the kernel tile choices run), with the
reference's defaults as fixed settings, bit for bit the reference's
results.  The seeded enumeration, the frontier enumeration for the DSE
sweep and the greedy order pass of the optimizer wait for the port's DSE.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.costmodel import BatchedCostModel, BatchOverflowError
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.energy import CostTable, Report, evaluate
from repro_torch.core.loopnest import LoopNest, TensorRef, divisors
from repro_torch.core.reuse import analyze
from repro_torch.core.schedule import ArraySpec, MemLevel, Schedule


# ------------------------------------------------------------------ orders --


def order_candidates(
    nest: LoopNest, active: Sequence[str], exhaustive_limit: int = 4
) -> list[tuple[str, ...]]:
    """Candidate loop orders (innermost-first) for one level.

    Only dims with trip > 1 ("active") matter; inactive dims are appended.
    If few are active, try all permutations; otherwise use stationarity
    templates: for each tensor, its irrelevant dims innermost (so it stays
    resident below), largest-trip-last inside groups.
    """
    inactive = [d for d in nest.dims if d not in active]
    if len(active) <= exhaustive_limit:
        return [tuple(p) + tuple(inactive) for p in itertools.permutations(active)]
    cands: list[tuple[str, ...]] = []
    seen = set()
    for t in nest.tensors:
        irr = [d for d in active if d not in t.relevant]
        rel = [d for d in active if d in t.relevant]
        cand = tuple(irr + rel + inactive)
        if cand not in seen:
            seen.add(cand)
            cands.append(cand)
    default = tuple(active) + tuple(inactive)
    if default not in seen:
        cands.append(default)
    return cands


# ------------------------------------------------------------------ tiling --


def _tile_choices(
    nest: LoopNest,
    rem: dict[str, int],
    base_tile: dict[str, int],
    capacity_words: int | None,
    double: bool,
    max_choices: int,
    keep: Callable[[dict[str, int]], bool] | None = None,
) -> list[dict[str, int]]:
    """Enumerate per-dim divisor factors whose cumulative footprint fits
    (and that ``keep`` accepts, before any subsampling)."""
    dims = sorted(rem, key=lambda d: -rem[d])
    out: list[dict[str, int]] = []

    def footprint(tile: dict[str, int]) -> int:
        full = {d: base_tile[d] * tile.get(d, 1) for d in nest.dims}
        words = sum(t.tile_elems(full) for t in nest.tensors)
        return words * (2 if double else 1)

    def rec(i: int, tile: dict[str, int]):
        if i == len(dims):
            out.append(dict(tile))
            return
        d = dims[i]
        for f in divisors(rem[d]):
            tile[d] = f
            if capacity_words is not None and footprint(tile) > capacity_words:
                del tile[d]
                break  # factors ascend; larger only grows footprint
            rec(i + 1, tile)
        tile.pop(d, None)

    rec(0, {})
    if keep is not None:
        out = [t for t in out if keep(t)]
    if len(out) > max_choices:
        # stratified subsample by footprint: keep spread from tiny to full
        out.sort(key=footprint)
        out = [out[i] for i in _strided_indices(len(out), max_choices)]
    return out


# The reference's default cap on the tiles tried per level.
MAX_CHOICES_PER_LEVEL = 512


def _strided_indices(n: int, k: int) -> list[int]:
    """<= k evenly-spaced indices into a length-n sequence (stratified
    subsample; callers sort by footprint first so the stride keeps a spread
    from tiny to full tiles).  Safe for k == 1 and k >= n."""
    if k >= n:
        return list(range(n))
    if k <= 1:
        return [0]
    return sorted({round(i * (n - 1) / (k - 1)) for i in range(k)})


@dataclasses.dataclass
class SearchResult:
    best: Report
    evaluated: int


def _level_energy(
    schedule: Schedule, table: CostTable, level: int
) -> float:
    """Energy contributed by accesses served at `level` (+ array hops when
    `level` is the array-feeding level).  Scalar oracle; the batched form is
    costmodel.BatchedCostModel.level_energy."""
    acc = analyze(schedule)
    e = acc.level_total(level) * table.level_pj[level]
    blevel = min(max(schedule.array_boundary, 1), len(schedule.levels) - 1)
    if level == blevel:
        e += sum(acc.hops.values()) * table.hop_pj
    return e


def _lb_elems(tensor: TensorRef, tile: dict[str, int]) -> int:
    """Lower bound on tile_elems that stays sound under any stride/halo
    configuration (min of the halo extent and the plain trip product)."""
    n = 1
    handled: set[str] = set()
    for base, (filt, stride) in tensor.coupled.items():
        b, f = tile.get(base, 1), tile.get(filt, 1)
        n *= min(stride * (b - 1) + f, b * f)
        handled.add(base)
        handled.add(filt)
    for d in tensor.dims:
        if d not in handled:
            n *= tile.get(d, 1)
    return n


def search_blocking(
    nest: LoopNest,
    levels: Sequence[MemLevel],
    array: ArraySpec,
    dataflow: Dataflow,
    beam: int = 24,
    tile_filter: Callable[[int, dict[str, int], dict[str, int]], bool] | None = None,
) -> SearchResult:
    """Top-down beam search with exact partial costs.

    Key property of the access model (reuse.py): the traffic served BY level l
    depends only on the tiling factors and loop orders at levels >= l (the
    child tile is then fixed by the remainder).  Choosing factors from the
    top (DRAM) inward therefore prices each level exactly when it is fixed —
    the paper's "domain-specific knowledge guided" pruned search made
    systematic.  A beam keeps the best partial hierarchies; per-level loop
    orders are optimized from stationarity templates as each level is fixed.

    The whole (tile x order) frontier of a level is priced in one batched
    call (costmodel.BatchedCostModel), or through the scalar oracle when the
    nest overflows the batched model's int64 arithmetic (identical results).
    A greedy dive first establishes an incumbent; beam expansions whose
    already-fixed cost plus an optimistic remainder (sound per-level traffic
    lower bounds + MAC energy) exceed it are skipped.  At most
    ``MAX_CHOICES_PER_LEVEL`` tiles are tried per level.

    ``tile_filter`` (not in the reference; None leaves every result as the
    reference's) describes a kernel's own limits to the search: called as
    ``tile_filter(l, factors, inner)`` with the factors a level-``l`` tile
    takes and the remainder left for the levels inside it, it refuses the
    tile by returning False, as a capacity check does (before the
    ``MAX_CHOICES_PER_LEVEL`` subsample, so a kernel's few legal tiles are
    never sampled away).
    """
    L = len(levels)
    levels = tuple(levels)
    spatial = dataflow.assigns
    dims = tuple(nest.dims)
    D = len(dims)
    dim_idx = {d: i for i, d in enumerate(dims)}
    default_order = dims
    sp_factor = {d: dataflow.factor(d) for d in dims}
    full_rem = {d: math.ceil(nest.bounds[d] / sp_factor[d]) for d in dims}
    boundary = next((i for i, lvl in enumerate(levels) if not lvl.per_pe), L)
    tbl = CostTable.for_levels(levels)

    cm: BatchedCostModel | None
    try:
        cm = BatchedCostModel(nest, levels, array=array, spatial=spatial, table=tbl)
    except BatchOverflowError:
        cm = None  # fall back to the scalar oracle

    def sched_from(til: np.ndarray, odr: np.ndarray) -> Schedule:
        """Materialize a Schedule from (L, D) tiling/order-index matrices
        (values converted to Python ints so downstream scalar arithmetic
        stays arbitrary-precision)."""
        tiling = {
            d: tuple(int(til[l, j]) for l in range(L))
            for j, d in enumerate(dims)
        }
        order = tuple(
            tuple(dims[int(i)] for i in odr[l]) for l in range(L)
        )
        return Schedule(
            nest=nest, levels=levels, tiling=tiling, order=order,
            array=array, spatial=spatial,
        )

    # order tuple -> (D,) index row, cached (few distinct orders per search)
    _order_idx: dict[tuple, np.ndarray] = {}

    def order_row(order: tuple) -> np.ndarray:
        got = _order_idx.get(order)
        if got is None:
            got = _order_idx[order] = np.array(
                [dim_idx[d] for d in order], dtype=np.int64
            )
        return got

    # active-dims tuple -> candidate orders (order_candidates is pure)
    _ocands: dict[tuple, list] = {}

    def cands_for(active: tuple) -> list:
        got = _ocands.get(active)
        if got is None:
            got = _ocands[active] = (
                order_candidates(nest, list(active)) if active
                else [default_order]
            )
        return got

    def assemble(g_til, g_odr, sizes, cand_rows, level):
        """Stack per-group (L, D) matrices into per-row arrays, substituting
        each row's candidate order at `level`."""
        til = np.repeat(np.stack(g_til), sizes, axis=0)
        odr = np.repeat(np.stack(g_odr), sizes, axis=0)
        odr[:, level, :] = np.stack(cand_rows)
        return til, odr

    def price_level(til, odr, l) -> np.ndarray:
        if cm is not None:
            return cm.level_energy(til, odr, l)
        return np.array(
            [_level_energy(sched_from(til[i], odr[i]), tbl, l)
             for i in range(til.shape[0])]
        )

    def price_full(til, odr) -> np.ndarray:
        if cm is not None:
            return cm.energy(til, odr)
        return np.array(
            [evaluate(sched_from(til[i], odr[i]), tbl).energy_pj
             for i in range(til.shape[0])]
        )

    # ------------------------------------------------ pruning lower bounds --
    # Sound optimistic completion cost for a partial hierarchy.  Two facts:
    #   * stationarity only absorbs IRRELEVANT loops, so for tensor T the
    #     reload count at any unfixed level is at least the product of T's
    #     relevant trips among the already-fixed outer factors (rvec), and
    #   * per reload, covering the remainder region with child tiles streams
    #     at least elems_T(region) words through the level (per PE for
    #     per-PE levels).
    # Hence  lb(l) = pj[l] * mult(l) * sum_T rvec_T * elems_T(region)  and
    # MAC energy is fixed by the nest.
    used_pes = dataflow.used_pes()
    mac_e = nest.macs() * tbl.mac_pj
    rel_dims = [t.relevant for t in nest.tensors]
    T = len(nest.tensors)

    def _tile_rvec(tile: dict[str, int]) -> tuple[int, ...]:
        return tuple(
            math.prod(f for d, f in tile.items() if d in rel_dims[t_i])
            for t_i in range(T)
        )

    _region_cache: dict[tuple, tuple] = {}

    def _region_words(l: int, rem: dict[str, int]) -> tuple[int, tuple[int, ...]]:
        """(mult, per-tensor elems of the level-l remainder region)."""
        per_pe_ish = l < max(boundary, 1)
        key = (per_pe_ish, tuple(rem[d] for d in dims))
        got = _region_cache.get(key)
        if got is None:
            region = {
                d: rem[d] * (1 if per_pe_ish else sp_factor[d]) for d in dims
            }
            got = _region_cache[key] = tuple(
                _lb_elems(t, region) for t in nest.tensors
            )
        return (used_pes if per_pe_ish else 1), got

    # Level 0 admits a second, usually stronger bound: whatever the blocking,
    # the innermost trip>1 temporal loop breaks stationarity for every tensor
    # its dim is relevant to, and each dim is relevant to >= k0 tensors — so
    # at least k0 tensors stream one word per MAC-boundary trip.
    _trips_total = math.prod(full_rem.values())
    _k0 = min(
        (sum(d in r for r in rel_dims) for d in dims if full_rem[d] > 1),
        default=T,
    )
    _lb0_const = _k0 * _trips_total * used_pes * tbl.level_pj[0]

    def lb_level(l: int, rem: dict[str, int], rvec: tuple[int, ...]) -> float:
        mult, words = _region_words(l, rem)
        e = sum(r * w for r, w in zip(rvec, words)) * mult * tbl.level_pj[l]
        return max(e, _lb0_const) if l == 0 else e

    def lb_below(l: int, rem: dict[str, int], rvec: tuple[int, ...]) -> float:
        return sum(lb_level(lp, rem, rvec) for lp in range(l))

    # Per-(rem, level-choice) expansion metadata, memoized across entries,
    # levels and the dive/main passes:
    #   tiles_for(rem) -> [(tile_vec, tile_rvec, active, new_rem, rem_key)]
    #   footprint of the level-(l-1) child tile keyed by (shared?, new_rem)
    _tile_cache: dict[tuple, list] = {}
    _foot_cache: dict[tuple, int] = {}

    def tiles_for(rem: dict[str, int], l: int) -> list:
        key = tuple(rem[d] for d in dims)
        keep = None
        if tile_filter is not None:
            key = (l, key)

            def keep(tile: dict[str, int]) -> bool:
                full = {d: tile.get(d, 1) for d in dims}
                return tile_filter(l, full, {d: rem[d] // full[d] for d in dims})
        got = _tile_cache.get(key)
        if got is None:
            base = {d: 1 for d in dims}
            got = []
            for tile in _tile_choices(
                nest, rem, base, None, False, MAX_CHOICES_PER_LEVEL, keep
            ):
                tile_vec = np.array(
                    [tile.get(d, 1) for d in dims], dtype=np.int64
                )
                new_rem = {d: rem[d] // tile.get(d, 1) for d in dims}
                active = tuple(d for d in dims if tile.get(d, 1) > 1)
                got.append(
                    (tile_vec, _tile_rvec(tile), active, new_rem,
                     tuple(new_rem[d] for d in dims))
                )
            _tile_cache[key] = got
        return got

    def child_words(child_is_shared: bool, new_rem: dict, rem_key: tuple) -> int:
        key = (child_is_shared, rem_key)
        got = _foot_cache.get(key)
        if got is None:
            child_tile = {
                d: new_rem[d] * (sp_factor[d] if child_is_shared else 1)
                for d in dims
            }
            got = _foot_cache[key] = sum(
                t.tile_elems(child_tile) for t in nest.tensors
            )
        return got

    evaluated = 0

    def run(width: int, incumbent: float) -> Report | None:
        nonlocal evaluated
        # beam entries: (partial_cost, til, odr, rem, rvec) with til/odr the
        # (L, D) tiling / order-index matrices of the fixed outer levels
        # (remainder parked at level 0, unfixed inner levels all-1/default).
        seed_til = np.ones((L, D), dtype=np.int64)
        seed_til[0] = [full_rem[d] for d in dims]
        seed_odr = np.tile(order_row(default_order), (L, 1))
        entries: list[tuple[float, np.ndarray, np.ndarray, dict, tuple]] = [
            (0.0, seed_til, seed_odr, dict(full_rem), (1,) * T)
        ]
        for l in range(L - 1, 0, -1):
            child_cap = levels[l - 1].capacity_bytes
            child_cap_words = (
                None if child_cap is None else child_cap // 2  # word_bytes=2
            )
            double = levels[l - 1].double_buffered
            child_is_shared = (l - 1) >= boundary
            g_til: list[np.ndarray] = []
            g_odr: list[np.ndarray] = []
            sizes: list[int] = []
            cand_rows: list[np.ndarray] = []
            groups: list[tuple] = []  # (cost, odr, new_rem, new_rvec, cands)
            n_rows = 0
            for cost, til, odr, rem, rvec in entries:
                if (
                    incumbent != math.inf
                    and cost + mac_e + lb_level(l, rem, rvec) > incumbent
                ):
                    continue
                lb_here = (
                    lb_level(l, rem, rvec) if incumbent != math.inf else 0.0
                )
                for tile_vec, tile_rvec, active, new_rem, rem_key in tiles_for(rem, l):
                    # child tile (everything still inside) must fit level l-1
                    if child_cap_words is not None:
                        words = child_words(child_is_shared, new_rem, rem_key)
                        if double:
                            words *= 2
                        if words > child_cap_words:
                            continue
                    new_rvec = tuple(r * f for r, f in zip(rvec, tile_rvec))
                    if incumbent != math.inf:
                        optimistic = (
                            cost + mac_e + lb_here
                            + lb_below(l, new_rem, new_rvec)
                        )
                        if optimistic > incumbent:
                            continue
                    cands = cands_for(active)
                    new_til = til.copy()
                    new_til[l] = tile_vec
                    new_til[0] = [new_rem[d] for d in dims]
                    g_til.append(new_til)
                    g_odr.append(odr)
                    sizes.append(len(cands))
                    cand_rows.extend(order_row(c) for c in cands)
                    n_rows += len(cands)
                    groups.append((cost, odr, new_rem, new_rvec, cands))
            if not groups:
                return None
            til_rows, odr_rows = assemble(g_til, g_odr, sizes, cand_rows, l)
            energies = price_level(til_rows, odr_rows, l)
            evaluated += n_rows
            nxt: list[tuple[float, np.ndarray, np.ndarray, dict, tuple]] = []
            start = 0
            for gi, (cost, odr, new_rem, new_rvec, cands) in enumerate(groups):
                k = sizes[gi]
                j = start + int(np.argmin(energies[start : start + k]))
                new_odr = odr.copy()
                new_odr[l] = cand_rows[j]
                nxt.append(
                    (cost + float(energies[j]), g_til[gi], new_odr,
                     new_rem, new_rvec)
                )
                start += k
            nxt.sort(key=lambda x: x[0])
            # dedup identical remainders (keep the cheapest) for beam diversity
            seen: set[tuple] = set()
            deduped: list[tuple] = []
            for e in nxt:
                rkey = tuple(e[3][d] for d in dims)
                if rkey in seen:
                    continue
                seen.add(rkey)
                deduped.append(e)
            entries = deduped[:width]

        # finalize: level-0 factors = remainder; optimize level-0 order.
        g_til, g_odr, sizes, cand_rows = [], [], [], []
        n_rows = 0
        for cost, til, odr, rem, _rvec in entries:
            active = tuple(d for d in dims if rem[d] > 1)
            cands = cands_for(active)
            g_til.append(til)
            g_odr.append(odr)
            sizes.append(len(cands))
            cand_rows.extend(order_row(c) for c in cands)
            n_rows += len(cands)
        if not g_til:
            return None
        til_rows, odr_rows = assemble(g_til, g_odr, sizes, cand_rows, 0)
        energies = price_full(til_rows, odr_rows)
        evaluated += n_rows
        j = int(np.argmin(energies))
        return evaluate(sched_from(til_rows[j], odr_rows[j]), tbl)

    # Greedy dive establishes the branch-and-bound incumbent cheaply.
    dive_rep = run(1, math.inf)
    incumbent = math.inf if dive_rep is None else dive_rep.energy_pj
    best = run(beam, incumbent)
    if best is None:
        best = dive_rep
    if best is None:
        raise ValueError("no feasible blocking fits the memory hierarchy")
    if dive_rep is not None and dive_rep.energy_pj < best.energy_pj:
        best = dive_rep
    return SearchResult(best=best, evaluated=evaluated)
