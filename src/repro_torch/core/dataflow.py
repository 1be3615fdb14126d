"""Dataflow taxonomy: spatial loop unrolling U | V with replication (paper §3.2).

A dataflow names which loops are unrolled on each physical dimension of the
PE array:  `U | V` unrolls loop U vertically and V horizontally; replication
(`U W | V`) maps several loops to one physical dim, nearest-first, to recover
utilization (paper Fig 2/3).  Table 1 of the paper:

    output stationary   X | Y
    weight stationary   FX | FY
    row stationary      FY | Y
    weight stationary   C | K     (TPU-style; used by the paper's optimizer)

`enumerate_dataflows` generates all (L choose 2) primary choices; `replicate`
greedily fills leftover PEs with additional loops, exactly the paper's fix
for under-utilization.

The port's copy of the reference's ``core/dataflow.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

from repro_torch.core.loopnest import LoopNest, divisors
from repro_torch.core.schedule import ArraySpec

# Canonical names from paper Table 1 (for reporting).
NAMED_DATAFLOWS = {
    ("X", "Y"): "output-stationary X|Y",
    ("FX", "FY"): "weight-stationary FX|FY",
    ("FY", "Y"): "row-stationary FY|Y",
    ("C", "K"): "weight-stationary C|K",
}


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """Spatial assignment: per array dim, ordered (loop, factor) pairs."""

    assigns: tuple[tuple[tuple[str, int], ...], ...]

    @property
    def primary(self) -> tuple[str, ...]:
        return tuple(a[0][0] if a else "-" for a in self.assigns)

    def label(self) -> str:
        parts = []
        for a in self.assigns:
            parts.append("".join(d for d, _ in a) or "-")
        tag = "|".join(parts)
        name = NAMED_DATAFLOWS.get(self.primary)
        return f"{tag} ({name})" if name else tag

    def factor(self, dim: str) -> int:
        f = 1
        for a in self.assigns:
            for d, s in a:
                if d == dim:
                    f *= s
        return f

    def used_pes(self) -> int:
        return math.prod(
            math.prod(f for _, f in a) if a else 1 for a in self.assigns
        )


def _best_factor(bound: int, budget: int) -> int:
    """Largest divisor of `bound` <= budget (>=1)."""
    best = 1
    for d in divisors(bound):
        if d <= budget:
            best = d
    return best


def _fill_dim(
    nest: LoopNest,
    primary: str,
    capacity: int,
    replication_pool: Sequence[str],
    remaining: dict[str, int],
) -> tuple[tuple[str, int], ...]:
    """Map `primary` on a physical dim of size `capacity`; replicate greedily
    from `replication_pool` (largest-first) to fill leftover PEs."""
    assigns: list[tuple[str, int]] = []
    f = _best_factor(remaining[primary], capacity)
    if f > 1:
        assigns.append((primary, f))
        remaining[primary] //= f
        capacity //= f
    for d in sorted(replication_pool, key=lambda d: -remaining[d]):
        if capacity <= 1:
            break
        g = _best_factor(remaining[d], capacity)
        if g > 1:
            assigns.append((d, g))
            remaining[d] //= g
            capacity //= g
    return tuple(assigns)


def make_dataflow(
    nest: LoopNest,
    array: ArraySpec,
    primary: Sequence[str],
    replication: bool = True,
) -> Dataflow:
    """Build a dataflow with primaries `primary` (one per array dim), greedily
    replicated if requested."""
    remaining = dict(nest.bounds)
    assigns = []
    for a, p in enumerate(primary):
        pool = (
            [d for d in nest.dims if d != p and d not in primary]
            if replication
            else []
        )
        assigns.append(
            _fill_dim(nest, p, array.dims[a], pool, remaining)
        )
    return Dataflow(assigns=tuple(assigns))


def enumerate_dataflows(
    nest: LoopNest,
    array: ArraySpec,
    replication: bool = True,
    min_bound: int = 2,
) -> list[Dataflow]:
    """All single-primary-per-dim dataflows (paper: (L choose d) choices)."""
    dims = [d for d in nest.dims if nest.bounds[d] >= min_bound]
    out = []
    seen = set()
    for combo in itertools.permutations(dims, len(array.dims)):
        df = make_dataflow(nest, array, combo, replication=replication)
        key = df.assigns
        if key in seen:
            continue
        seen.add(key)
        out.append(df)
    return out
