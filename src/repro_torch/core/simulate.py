"""Exact tile-granular memory-hierarchy simulator (validation oracle).

The paper validates its analytical model against post-synthesis ASIC designs
(<2% error, Fig 7).  No synthesis toolchain exists in this environment, so we
validate against an *exact* simulator instead: it tracks which child tile is
resident in each memory level for each tensor across every temporal loop
iteration of a schedule and counts actual reload traffic.  The stationarity
behaviour emerges from first principles here (a tile is re-fetched iff the
required tile id differs from the resident one), whereas reuse.py derives it
with closed-form products — agreement between the two on randomized schedules
(the reference's tests/test_reuse_model.py) is the repo's analogue of the
paper's Fig 7.

Two engines, mirroring the costmodel.py batched/scalar split:

  * ``engine="scalar"`` — the original per-iteration Python odometer.  It
    walks all ``N = prod(trips)`` iterations and compares resident-tile keys
    one by one: O(N * levels * tensors) Python steps.  Kept verbatim as the
    differential oracle (the reference's tests/test_simulate.py proves the engines
    bit-identical on randomized schedules).

  * ``engine="vector"`` (default) — residency-change counting over the
    mixed-radix structure of the loop nest.  The resident-tile key of
    (level l, tensor T) is the tuple of odometer digits at the loop
    positions that are both at levels >= l and over dims relevant to T.
    Digit p of the odometer changes at iteration n exactly when the product
    of trips strictly inner to p divides n, and those suffix products are
    nested under divisibility — so "any key digit changed" collapses to
    "the suffix product inner to the *innermost* key position divides n".
    Reload counts therefore come from a handful of array reductions over
    the (levels x tensors x loop-positions) masks instead of an O(N) walk:

        reloads(l, T)     = N // suffix[max(key positions) + 1]
        first_touch(l, T) = prod(trips at key positions)   (distinct keys)

    O(levels * tensors * positions) total — independent of the iteration
    count, so the oracle now validates full-size layer schedules, not just
    toy bounds.

Only temporal schedules are simulated (spatial factors folded out by the
caller); the array-level multicast/hop terms are simple closed forms already.

The port's copy of the reference's ``core/simulate.py``, held to it bit for
bit by ``tests/test_torch_core_dse.py``.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.reuse import AccessCounts
from repro_torch.core.schedule import Schedule

# Past this iteration count the int64 suffix products could wrap; the vector
# engine switches to Python big-int arithmetic (same formulas, still exact).
_INT64_SAFE_ITERS = 2 ** 62


def _loop_stack(schedule: Schedule) -> list[tuple[str, int, int]]:
    """Temporal loops outermost -> innermost: (dim, trip, level), trip > 1."""
    loops: list[tuple[str, int, int]] = []
    for l in range(len(schedule.levels) - 1, -1, -1):
        for d in reversed(schedule.order[l]):
            trip = schedule.tiling[d][l]
            if trip > 1:
                loops.append((d, trip, l))
    return loops


def simulate(schedule: Schedule, engine: str = "vector") -> AccessCounts:
    """Exact access counts for one schedule (see module docstring)."""
    if engine == "vector":
        return _simulate_vector(schedule)
    if engine == "scalar":
        return _simulate_scalar(schedule)
    raise ValueError(f"unknown simulate engine {engine!r}")


# ------------------------------------------------------------------ vector --


def _counts_to_access(
    schedule: Schedule,
    reloads: list[list[int]],
    first_touch: list[list[int]],
) -> AccessCounts:
    """Shared reloads/first-touch -> AccessCounts conversion (both engines)."""
    nest = schedule.nest
    L = len(schedule.levels)
    tensors = nest.tensors
    reads: list[dict[str, int]] = [dict() for _ in range(L)]
    writes: list[dict[str, int]] = [dict() for _ in range(L)]
    for l in range(L):
        child = schedule.child_tile(l)
        for ti, t in enumerate(tensors):
            elems = t.tile_elems(child)
            n = reloads[l][ti] * elems
            if t.output:
                writes[l][t.name] = n
                # each tile's first streaming up is write-only; later
                # re-streams read the partial back first
                reads[l][t.name] = n - first_touch[l][ti] * elems
            else:
                reads[l][t.name] = n
                writes[l][t.name] = 0
    return AccessCounts(
        reads=tuple(reads),
        writes=tuple(writes),
        hops={t.name: 0.0 for t in tensors},
        macs=nest.macs(),
        utilization=schedule.utilization(),
    )


def _simulate_vector(schedule: Schedule) -> AccessCounts:
    nest = schedule.nest
    L = len(schedule.levels)
    tensors = nest.tensors
    T = len(tensors)
    loops = _loop_stack(schedule)
    P = len(loops)
    total = math.prod(trip for _, trip, _ in loops)

    if P == 0:
        ones = [[1] * T for _ in range(L)]
        return _counts_to_access(schedule, ones, ones)

    if total >= _INT64_SAFE_ITERS:
        reloads, first = _mixed_radix_counts_bigint(loops, tensors, L, total)
        return _counts_to_access(schedule, reloads, first)

    trips = np.array([trip for _, trip, _ in loops], dtype=np.int64)
    lvls = np.array([l for _, _, l in loops], dtype=np.int64)
    rel = np.array(
        [[d in t.relevant for d, _, _ in loops] for t in tensors], dtype=bool
    )  # (T, P)
    # key[l, t, p]: loop position p feeds the resident-tile key of (l, t)
    key = (lvls[None, :] >= np.arange(L)[:, None])[:, None, :] & rel[None, :, :]

    # suffix[p] = product of trips at positions >= p (suffix[P] = 1)
    suffix = np.ones(P + 1, dtype=np.int64)
    suffix[:P] = np.cumprod(trips[::-1])[::-1]

    # innermost key position; -1 (empty key) maps to suffix[0] = N -> 1 reload
    m = np.where(key, np.arange(P)[None, None, :], -1).max(axis=2)  # (L, T)
    reloads = total // suffix[m + 1]
    first = np.where(key, trips[None, None, :], 1).prod(axis=2)

    # downstream arithmetic (reloads * tile elems) must stay arbitrary
    # precision like the scalar oracle, so hand back Python ints
    return _counts_to_access(
        schedule,
        [[int(reloads[l, ti]) for ti in range(T)] for l in range(L)],
        [[int(first[l, ti]) for ti in range(T)] for l in range(L)],
    )


def _mixed_radix_counts_bigint(
    loops: list[tuple[str, int, int]], tensors, L: int, total: int
) -> tuple[list[list[int]], list[list[int]]]:
    """Same formulas as the NumPy path in Python big-int arithmetic, for
    schedules whose iteration count exceeds exact int64 range."""
    P = len(loops)
    suffix = [1] * (P + 1)
    for p in range(P - 1, -1, -1):
        suffix[p] = suffix[p + 1] * loops[p][1]
    reloads = [[1] * len(tensors) for _ in range(L)]
    first = [[1] * len(tensors) for _ in range(L)]
    for l in range(L):
        for ti, t in enumerate(tensors):
            rel = t.relevant
            m = -1
            f = 1
            for p, (d, trip, ll) in enumerate(loops):
                if ll >= l and d in rel:
                    m = p
                    f *= trip
            reloads[l][ti] = total // suffix[m + 1]
            first[l][ti] = f
    return reloads, first


# ------------------------------------------------------------------ scalar --


def _simulate_scalar(schedule: Schedule) -> AccessCounts:
    """The original per-iteration odometer (differential oracle)."""
    nest = schedule.nest
    L = len(schedule.levels)
    loops = _loop_stack(schedule)
    n_loops = len(loops)
    counters = [0] * n_loops

    # Pre-compute, for every (level, tensor): which loop positions feed its id
    # (loops at levels >= level over dims relevant to the tensor).
    tensors = nest.tensors
    keys: list[list[list[int]]] = []  # [level][tensor] -> loop positions
    for l in range(L):
        keys.append(
            [
                [i for i, (d, _, ll) in enumerate(loops) if ll >= l and d in t.relevant]
                for t in tensors
            ]
        )

    resident: list[list[tuple | None]] = [[None] * len(tensors) for _ in range(L)]
    reloads = [[0] * len(tensors) for _ in range(L)]
    first_touch = [[0] * len(tensors) for _ in range(L)]
    seen: list[list[set]] = [[set() for _ in tensors] for _ in range(L)]

    total_iters = 1
    for _, trip, _ in loops:
        total_iters *= trip

    for _ in range(total_iters):
        for l in range(L):
            for ti in range(len(tensors)):
                key = tuple(counters[i] for i in keys[l][ti])
                if resident[l][ti] != key:
                    resident[l][ti] = key
                    reloads[l][ti] += 1
                    if key not in seen[l][ti]:
                        seen[l][ti].add(key)
                        first_touch[l][ti] += 1
        # odometer increment (innermost = last position)
        for i in range(n_loops - 1, -1, -1):
            counters[i] += 1
            if counters[i] < loops[i][1]:
                break
            counters[i] = 0

    return _counts_to_access(schedule, reloads, first_touch)
