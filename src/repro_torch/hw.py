"""The NVIDIA H100 SXM as the port's tile searches and rooflines see it.

The H100 counterparts of the reference's TPU constants
(``repro/core/energy.py:192-196``), from NVIDIA's H100 data sheet and
the CUDA documentation: dense tensor-core peak, fp32 CUDA-core peak, HBM3
rate and size, SM count and shared memory.  ``chip_smoke.py`` takes its roofline rates from here.
"""

from __future__ import annotations

from repro_torch.core.schedule import ArraySpec, MemLevel

SM_COUNT = 132
SMEM_PER_BLOCK_BYTES = 232_448      # 227 KB: the most one block may ask for
SMEM_PER_SM_BYTES = 233_472         # 228 KB per SM, shared by its blocks
SMEM_RESERVED_PER_BLOCK_BYTES = 1024  # the system's share of each block
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32                  # resident blocks an SM holds at most
REGISTERS_PER_SM = 65_536           # 32-bit registers
HBM_BYTES_PER_S = 3.35e12           # HBM3
HBM_BYTES = 80 * 1024**3
BF16_FLOPS_PER_S = 989e12           # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 66.9e12          # fp32 on the CUDA cores (no tensor cores)
MMA_ALIGN = 16                      # channel alignment of the fp32 conv body's tiles

# Shared memory one block of the fp32 conv body may use: half of an SM's,
# less the system's share of each block, so that at least two blocks fit
# on every SM and one block's loads overlap the other's math.
SMEM_BUDGET_BYTES = SMEM_PER_SM_BYTES // 2 - SMEM_RESERVED_PER_BLOCK_BYTES


def hopper_f32_levels() -> tuple[MemLevel, MemLevel]:
    """The (shared memory, HBM) hierarchy the fp32 conv body's tiles are
    searched on (``csrc/conv2d.cu``: ``conv2d_f32_kernel``, CUDA cores):
    the counterpart of the reference's (VMEM, HBM) pair.

    Shared memory holds ``SMEM_BUDGET_BYTES`` (113 KB, 115,712 B) per
    block: at least two blocks per SM (each SM has 228 KB, and the system
    keeps 1 KB of it for each resident block), so that one block's loads
    from HBM overlap another's work.  The level is single buffered, as
    that body is: it stages one tile at a time.
    """
    return (
        MemLevel("SMEM", capacity_bytes=SMEM_BUDGET_BYTES, double_buffered=False),
        MemLevel("HBM", capacity_bytes=None),
    )


# The tensor cores as the bf16 conv body (csrc/conv2d.cu: conv2d_tc_kernel)
# drives them: wgmma tiles of 64 pixel rows, 16 input channels deep, N
# output channels wide (a multiple of 8 up to 256); two consumer
# warpgroups per block; the filter read from shared memory in 64-column
# panels, each one 128-byte TMA swizzle span of bf16.
WGMMA_M = 64
WGMMA_K = 16
WGMMA_MAX_N = 256
CONV_CONSUMER_WARPGROUPS = 2
CONV_PANEL = 64
CONV_RING_STAGES = (2, 4)         # the fewest and the most stages of the ring
# what one block's ring may take: a block's shared memory, less 1 KB to
# align the stages to the 128-byte swizzle's 1024-byte atoms and the
# ring's barriers
CONV_RING_BYTES = SMEM_PER_BLOCK_BYTES - 1024 - 16 * CONV_RING_STAGES[1]
L2_BYTES = 50 * 2**20


def hopper_array() -> ArraySpec:
    """The PE array of the paper's model, as the tensor cores of one SM are
    used by the bf16 conv body: output stationary over pixels x output
    channels.  One PE is one (pixel, output channel) lane of the block's
    two 64-row wgmma tiles: 128 pixel rows (two consumer warpgroups of 64)
    by one 64-column filter panel.  A dataflow unrolls the pixel loops
    (``B``, ``X``, ``Y``, replicated on the first dimension) and ``K`` (64,
    on the second)."""
    return ArraySpec(dims=(CONV_CONSUMER_WARPGROUPS * WGMMA_M, CONV_PANEL))


def hopper_levels() -> tuple[MemLevel, ...]:
    """The H100 as the paper describes an accelerator, for the bf16 conv
    body's tile search: per-PE registers, the shared-memory ring, the L2
    cache and HBM.

    - ``REG`` (per PE): the fp32 accumulators stay in registers, at most
      128 x 256 per block (128 per consumer thread), so a PE (one lane of a
      64-column panel) holds at most ``WGMMA_MAX_N / CONV_PANEL`` = 4 of
      them: 4 outputs, one input and 4 filter words in the paper's 16-bit
      words.
    - ``SMEM``: a ring of 2-4 stages (``CONV_RING_STAGES``); a stage holds
      one bc-channel step of the haloed input tile and of the whole filter
      window.  The level's capacity is the ring's bytes; the search counts
      one stage (and the output tile, which the kernel keeps in registers:
      the paper's levels hold every tensor), and the conv search's tile
      filter (``kernels/conv2d/ops.py``) holds two stages to the ring.
    - ``L2`` (50 MB, shared by the SMs): what a block streams over its C
      loop; tiles of the grid that share inputs or filters meet here.
    - ``HBM``: the grid of blocks.
    """
    acc = WGMMA_MAX_N // CONV_PANEL
    return (
        MemLevel("REG", capacity_bytes=2 * (2 * acc + 1), per_pe=True, double_buffered=False),
        MemLevel("SMEM", capacity_bytes=CONV_RING_BYTES, double_buffered=False),
        MemLevel("L2", capacity_bytes=L2_BYTES, double_buffered=False),
        MemLevel("HBM", capacity_bytes=None),
    )


# The tensor cores as the bf16 GEMM's skinny body (csrc/matmul.cu) drives
# them: wgmma m64nNk16 with the weight as the 64-row operand (64 output
# columns a consumer warpgroup) and the activation rows as N; one 64-k
# panel of both a ring stage.
GEMM_TILE_N = 64
GEMM_PANEL_K = 64


def hopper_gemm_array(rows: int) -> ArraySpec:
    """One consumer warpgroup's wgmma as the paper's PE array, output
    stationary: ``GEMM_TILE_N`` weight rows (the output's columns, N) by
    ``rows`` activation rows (M)."""
    return ArraySpec(dims=(GEMM_TILE_N, rows))


def hopper_gemm_levels() -> tuple[MemLevel, ...]:
    """The H100 as the paper describes an accelerator, for the GEMM's split
    search (``kernels/matmul/ops.py``: ``gemm_search``): per-PE registers
    (one fp32 accumulator and one word of each operand), the shared-memory
    ring (a stage: one 64-k panel of the weight tile and of the activation
    rows), the L2 cache (what a block streams over its chunk of K) and HBM
    (the grid: output-column tiles x K chunks)."""
    return (
        MemLevel("REG", capacity_bytes=2 * (2 + 2), per_pe=True, double_buffered=False),
        MemLevel("SMEM", capacity_bytes=CONV_RING_BYTES, double_buffered=False),
        MemLevel("L2", capacity_bytes=L2_BYTES, double_buffered=False),
        MemLevel("HBM", capacity_bytes=None),
    )
