"""The NVIDIA H100 SXM as the port's tile searches and rooflines see it.

The H100 counterparts of the reference's TPU constants
(``repro/core/energy.py:192-196``), from NVIDIA's H100 data sheet and
the CUDA documentation: dense tensor-core peak, HBM3 rate and size, SM
count and shared memory.  ``chip_smoke.py`` takes its roofline rates from here.
"""

from __future__ import annotations

from repro_torch.core.schedule import MemLevel

SM_COUNT = 132
SMEM_PER_BLOCK_BYTES = 232_448      # 227 KB: the most one block may ask for
SMEM_PER_SM_BYTES = 233_472         # 228 KB per SM, shared by its blocks
SMEM_RESERVED_PER_BLOCK_BYTES = 1024  # the system's share of each block
HBM_BYTES_PER_S = 3.35e12           # HBM3
HBM_BYTES = 80 * 1024**3
BF16_FLOPS_PER_S = 989e12           # dense bf16 tensor-core peak
MMA_ALIGN = 16                      # bf16 mma.sync k-depth and m-height

# Shared memory one block of a kernel tiled by the search may use: half of
# an SM's, less the system's share of each block, so that at least two
# blocks fit on every SM and one block's loads overlap the other's math.
SMEM_BUDGET_BYTES = SMEM_PER_SM_BYTES // 2 - SMEM_RESERVED_PER_BLOCK_BYTES


def hopper_levels() -> tuple[MemLevel, MemLevel]:
    """The (shared memory, HBM) hierarchy the port's kernel tiles are
    searched on: the counterpart of the reference's (VMEM, HBM) pair.

    Shared memory holds ``SMEM_BUDGET_BYTES`` (113 KB, 115,712 B) per
    block: at least two blocks per SM (each SM has 228 KB, and the system
    keeps 1 KB of it for each resident block), so that one block's loads
    from HBM overlap another's tensor-core work.  The level is single
    buffered, as ``csrc/conv2d.cu`` is: it stages one tile at a time, so the
    search may give a tile the whole budget.
    """
    return (
        MemLevel("SMEM", capacity_bytes=SMEM_BUDGET_BYTES, double_buffered=False),
        MemLevel("HBM", capacity_bytes=None),
    )
