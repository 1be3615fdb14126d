"""Cost models: E = sum_i #acc_i * e_i  (paper §5, Table 3) + perf roofline.

Two cost tables:

  * ASIC 28 nm (paper Table 3) — used for the faithful reproduction of every
    figure in §6.  Energy per 16-bit access:
        RF:    0.03 pJ @ 16 B, linear in size        (0.03 * size/16)
        SRAM:  6 pJ @ 32 KB, x1.5 per size doubling  (6 * 1.5^log2(S/32K))
        MAC:   0.075 pJ      hop: 0.035 pJ           DRAM: 200 pJ
  * TPU v5e — time-per-byte table for the mapper/roofline (197 TFLOP/s bf16,
    819 GB/s HBM, ~50 GB/s/link ICI, ~  VMEM modeled as compute-rate-matched).

The performance model is the same max() roofline the paper uses implicitly
("keeping throughput constant"): latency = max(compute, each level's
bandwidth term), assuming double-buffered overlap (paper Fig 5).

The port's copy of the reference's ``core/energy.py``: the tables, the
``TPU_*`` constants (the reference's tile searches run on them, and the
port's parity tests rerun those searches) and ``evaluate``.  The H100's
counterparts are in ``repro_torch/hw.py``.  The ABFT and serve-traffic
pricing wait for the port's serve planner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.core.reuse import AccessCounts, analyze
from repro_torch.core.schedule import Schedule

# ------------------------------------------------------------------ tables --

RF_BASE_BYTES = 16
RF_BASE_PJ = 0.03
SRAM_BASE_BYTES = 32 * 1024
SRAM_BASE_PJ = 6.0
SRAM_DOUBLING = 1.5
MAC_PJ = 0.075
HOP_PJ = 0.035
DRAM_PJ = 200.0
RF_SRAM_CROSSOVER_BYTES = 4096  # below this, model as RF; above, as SRAM


def asic_access_energy_pj(capacity_bytes: int | None) -> float:
    """Energy per 16-bit access for a memory of the given capacity."""
    if capacity_bytes is None:
        return DRAM_PJ
    if capacity_bytes <= RF_SRAM_CROSSOVER_BYTES:
        return RF_BASE_PJ * capacity_bytes / RF_BASE_BYTES
    return SRAM_BASE_PJ * SRAM_DOUBLING ** math.log2(capacity_bytes / SRAM_BASE_BYTES)


@dataclasses.dataclass(frozen=True)
class CostTable:
    """Energy per access per level + datapath/communication costs."""

    level_pj: tuple[float, ...]
    mac_pj: float = MAC_PJ
    hop_pj: float = HOP_PJ

    @classmethod
    def for_levels(cls, levels) -> "CostTable":
        """Paper Table 3 energies for a hierarchy, independent of any
        schedule — build once per hardware config and share across the
        whole layer/blocking sweep (the table depends only on capacities)."""
        return cls(
            level_pj=tuple(
                asic_access_energy_pj(lvl.capacity_bytes) for lvl in levels
            )
        )

    @classmethod
    def asic_28nm(cls, schedule: Schedule) -> "CostTable":
        return cls.for_levels(schedule.levels)


# TPU v5e constants (per chip) — shared with benchmarks/roofline.py.
TPU_PEAK_FLOPS_BF16 = 197e12
TPU_HBM_BYTES_PER_S = 819e9
TPU_ICI_BYTES_PER_S_PER_LINK = 50e9
TPU_VMEM_BYTES = 64 * 1024 * 1024          # usable VMEM working-set budget
TPU_HBM_BYTES = 16 * 1024**3


# ------------------------------------------------------------------ report --


@dataclasses.dataclass(frozen=True)
class Report:
    """Energy/perf evaluation of one schedule under one cost table."""

    schedule: Schedule
    access: AccessCounts
    energy_pj: float
    breakdown_pj: Mapping[str, float]      # per level name + "mac" + "array"
    cycles: float
    utilization: float


def evaluate(
    schedule: Schedule,
    table: CostTable | None = None,
    access: AccessCounts | None = None,
) -> Report:
    table = table or CostTable.asic_28nm(schedule)
    acc = access if access is not None else analyze(schedule)

    breakdown: dict[str, float] = {}
    total = 0.0
    for l, lvl in enumerate(schedule.levels):
        n = acc.level_total(l)
        e = n * table.level_pj[l]
        breakdown[lvl.name] = e
        total += e
    mac_e = acc.macs * table.mac_pj
    hop_e = sum(acc.hops.values()) * table.hop_pj
    breakdown["mac"] = mac_e
    breakdown["array"] = hop_e
    total += mac_e + hop_e

    # perf: each PE does 1 MAC/cycle; levels stream at their bandwidth.
    compute_cycles = schedule.temporal_trips()
    cycles = float(compute_cycles)
    for l, lvl in enumerate(schedule.levels):
        bw = lvl.bandwidth_words_per_cycle
        if math.isfinite(bw):
            cycles = max(cycles, acc.level_total(l) / bw)

    return Report(
        schedule=schedule,
        access=acc,
        energy_pj=total,
        breakdown_pj=breakdown,
        cycles=cycles,
        utilization=acc.utilization,
    )
