"""Dataflow taxonomy: spatial loop unrolling U | V with replication (paper §3.2).

A dataflow names which loops are unrolled on each physical dimension of the
PE array:  `U | V` unrolls loop U vertically and V horizontally; replication
(`U W | V`) maps several loops to one physical dim, nearest-first, to recover
utilization (paper Fig 2/3).  Table 1 of the paper:

    output stationary   X | Y
    weight stationary   FX | FY
    row stationary      FY | Y
    weight stationary   C | K     (TPU-style; used by the paper's optimizer)

The port's copy of the reference's ``core/dataflow.py`` keeps only the
``Dataflow`` value the blocking search takes (the kernel tile searches run
with no spatial unrolling); the dataflow enumeration waits for the port's
optimizer.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """Spatial assignment: per array dim, ordered (loop, factor) pairs."""

    assigns: tuple[tuple[tuple[str, int], ...], ...]

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
