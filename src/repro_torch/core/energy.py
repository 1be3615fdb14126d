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
port's parity tests rerun those searches), ``evaluate`` and the ABFT and
serve-traffic pricing of the serve planner.  The H100's counterparts are in
``repro_torch/hw.py``.
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


# -------------------------------------------------------------- abft cost --


@dataclasses.dataclass(frozen=True)
class AbftCost:
    """Extra work the ABFT column checksum (kernels/abft.py) adds to one
    (M, N, K) matmul blocked at row-block ``bm``: the e^T·A checksum row
    is *appended to A* and rides the product GEMM (one extra output row
    per row block — the classical Huang–Abraham construction), every
    output element is reduced into a column sum, and the tolerance comes
    from static per-column |B| stats precomputed once at init (so B is
    never re-read per call).  Counted separately from the base matmul so
    schedule sweeps can report the surcharge as a ratio."""

    macs: int   # the fused checksum row: one extra GEMM row per row block
    adds: int   # column sums of C + the e^T reduction of A + compares
    words: int  # A read by the e^T reduction + checksum rows, top level

    @property
    def ops(self) -> int:
        return self.macs + self.adds


def abft_matmul_cost(M: int, N: int, K: int, bm: int) -> AbftCost:
    """Count the fused checksum side-channel.  Everything is
    O(M·K + K·N + M·N) arithmetic but only O(M·K + N) *traffic* — the
    O(M·K·N) product is never redone (the Huang–Abraham identity) and B
    is never re-read (the checksum row shares the product's weight pass;
    the tolerance scale is static).  On a memory-bound serving step the
    traffic term is the one that matters."""
    nrb = -(-M // bm)
    return AbftCost(
        # (e^T·A)·B per row block, fused as one extra GEMM output row
        macs=nrb * K * N,
        # in-kernel column sums (each output element reduced once), the
        # e^T column reduction of A, and the final compares
        adds=M * N + M * K + nrb * N,
        # A re-read by the e^T reduction, checksum rows written + read;
        # B rides the product's own pass, so it never re-crosses the top
        words=M * K + 2 * nrb * N,
    )


def abft_energy_pj(cost: AbftCost, table: CostTable) -> float:
    """Price the surcharge under a paper Table-3 cost table: arithmetic at
    MAC cost (an fp32 add/compare is bounded above by a MAC) and traffic
    at the outermost level's per-access energy — the checksum row
    streams its extra operands once and never tiles into the hierarchy."""
    return cost.ops * table.mac_pj + cost.words * table.level_pj[-1]


# ------------------------------------------------- serve decode traffic --


@dataclasses.dataclass(frozen=True)
class AttentionGatherCost:
    """Per-row, per-layer decode-attention HBM traffic under the paged (or
    split-pinned contiguous) flash-decoding kernel, as a function of
    ``(block_size, kv_splits, live length)`` — the quantity the serve-config
    planner (core/serveplan.py) sweeps.  All counts are 16-bit words."""

    kv_words: int       # K+V reads, padded to whole blocks (fragmentation)
    table_words: int    # block-table entries prefetched for the row
    partial_words: int  # per-split online-softmax partials (m, l, acc)

    @property
    def words(self) -> int:
        return self.kv_words + self.table_words + self.partial_words


def attention_gather_cost(
    ctx_len: int,
    *,
    block_size: int,
    kv_heads: int,
    head_dim: int,
    kv_splits: int | None = None,
) -> AttentionGatherCost:
    """Count one row's decode-attention gather for one layer.

    The kernel reads ``ceil(ctx_len / block_size)`` whole KV blocks per kv
    head (the tail block is read in full even when mostly dead — the
    internal-fragmentation cost of a large ``block_size``), prefetches that
    many block-table entries, and writes+combines one ``(head_dim + 2)``
    online-softmax partial per split per kv head (``m``, ``l``, and the
    accumulator row).  ``kv_splits`` defaults to the live block count (the
    paged kernel's grid skips dead splits); the contiguous twin pins it to
    ``max_len / decode_block`` and pays the full combine."""
    if ctx_len < 1 or block_size < 1:
        raise ValueError(
            f"ctx_len and block_size must be >= 1: {ctx_len}, {block_size}"
        )
    blocks = -(-ctx_len // block_size)
    splits = blocks if kv_splits is None else max(kv_splits, 1)
    return AttentionGatherCost(
        kv_words=2 * blocks * block_size * kv_heads * head_dim,
        table_words=blocks,
        # each split's partial is written by the split pass and read by the
        # combine pass, hence the factor 2
        partial_words=2 * splits * kv_heads * (head_dim + 2),
    )


def serve_step_energy_pj(
    macs: float, hbm_words: float, smem_words: float, smem_bytes: int
) -> float:
    """Paper Table-3 pricing of one decode step: MACs at datapath cost, HBM
    words at DRAM cost, on-chip words at the SRAM energy of the given
    capacity -- the E = sum #acc_i * e_i contraction with the serve
    hierarchy's two levels (the reference's VMEM level is the H100's shared
    memory here).  Used by core/serveplan.py to report energy-per-token
    next to the throughput roofline."""
    return (
        macs * MAC_PJ
        + hbm_words * DRAM_PJ
        + smem_words * asic_access_energy_pj(smem_bytes)
    )


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
