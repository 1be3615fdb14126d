"""Public GEMM entry points; port of ``repro/kernels/matmul/ops.py``.

The reference pads to mapper-chosen tile multiples and slices back; the
CUDA kernels mask their ragged edges and plan their own launch
(``matmul.plan``), so :func:`matmul` is the kernel wrapper itself, and
:func:`matmul_abft` adds the checksum verdict around the checksum GEMM.

:func:`gemm_search` is the paper's blocking search on the GEMM nest as the
H100 runs it (``hw.hopper_gemm_levels``, ``hw.hopper_gemm_array``): the K
split that ``matmul.k_split`` gives the kernel is its choice.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import hw
from repro_torch.core.blocking import search_blocking
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.energy import Report
from repro_torch.core.loopnest import matmul_nest
from repro_torch.kernels.abft import ABFT_ATOL, ABFT_RTOL
from repro_torch.kernels.matmul.matmul import (
    MAX_SPLIT,
    abft_block_rows,
    matmul_abft_cuda,
    matmul_cuda,
)

# the decode M the split is searched at (the skinny body's narrowest tile):
# the split is a function of (N, K) alone, so it is searched at one M
SEARCH_M = 8


@dataclasses.dataclass(frozen=True)
class SplitChoice:
    """The K split and the search result it came from: ``report`` is the
    paper's model on the chosen blocking (per-level factors: the grid's
    column tiles and chunks, the chunk's panels streamed through L2, one
    panel a ring stage)."""

    split: int
    report: Report


def _split_filter(split: int):
    """The skinny body's limits as a tile filter for ``search_blocking`` on
    ``hw.hopper_gemm_levels()`` (REG 0, SMEM 1, L2 2, HBM 3): the grid (HBM)
    splits the output's columns into the array's 64-column tiles and K into
    ``split`` chunks, never M (one M tile); a block (L2) streams only its
    chunk's K, 64 a ring stage (SMEM); a PE holds one k at a time."""

    def keep(level: int, f: dict, inner: dict) -> bool:
        if level == 3:
            return f["M"] == 1 and f["K"] == split and inner["N"] == 1
        if level == 2:
            return f["M"] == f["N"] == 1 and inner["K"] == hw.GEMM_PANEL_K
        if level == 1:
            return f["M"] == f["N"] == 1 and inner["K"] == 1
        return True

    return keep


@functools.lru_cache(maxsize=256)
def gemm_search(N: int, K: int) -> SplitChoice:
    """The K split by the paper's optimizer: for each split of 1 to
    ``MAX_SPLIT`` chunks (at most the 64-k panels), the blocking search on
    the GEMM nest at ``SEARCH_M`` rows, N padded to the array's 64 columns
    and K to whole chunks of the longest chunk's panels, over
    ``hw.hopper_gemm_levels()`` with the kernel's limits as its tile filter.
    The paper's model times one array; the card has ``hw.SM_COUNT`` SMs,
    each taking the grid's blocks in turn, so a split takes ``ceil(blocks /
    SMs)`` block times of the model's cycles.  The best by that time, then
    by the model's energy (a chunk more writes and reads one more partial
    sum of every output)."""
    kp = -(-K // hw.GEMM_PANEL_K)
    nt = -(-N // hw.GEMM_TILE_N)
    flow = Dataflow(assigns=((("N", hw.GEMM_TILE_N),), (("M", SEARCH_M),)))
    best = None
    for split in range(1, max(1, min(MAX_SPLIT, kp)) + 1):
        nest = matmul_nest("gemm", M=SEARCH_M, N=nt * hw.GEMM_TILE_N,
                           K=split * -(-kp // split) * hw.GEMM_PANEL_K)
        rep = search_blocking(nest, hw.hopper_gemm_levels(), hw.hopper_gemm_array(SEARCH_M),
                              flow, beam=4, tile_filter=_split_filter(split)).best
        blocks = nt * split
        key = (float(f"{-(-blocks // hw.SM_COUNT) * rep.cycles / blocks:.9g}"), rep.energy_pj)
        if best is None or key < best[0]:
            best = (key, SplitChoice(split, rep))
    return best[1]


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    """General (M, K) x (K, N) (or x (N, K)^T with ``trans_b``) -> (M, N)."""
    return matmul_cuda(a, b, trans_b=trans_b)


def matmul_abft(
    a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """ABFT-checked :func:`matmul`: returns ``(out, bad)``, ``bad`` a 0-d
    bool tensor on the operands' device, True iff the kernel's per-row-block
    column checksums e^T·C disagree with the reference (e^T·A)·B beyond the
    calibrated fp32 tolerance ``ABFT_ATOL + ABFT_RTOL·(e^T·|A|)·|B|``.  The
    reference side is a plain fp32 product outside the kernel, as in the
    reference (``ops.py:67-74``); its row blocks are the kernel's."""
    out, checks = matmul_abft_cuda(a, b, trans_b=trans_b)
    M, K = a.shape
    bm = abft_block_rows(M)
    nrb = checks.shape[0]
    a32 = torch.nn.functional.pad(a.float(), (0, 0, 0, nrb * bm - M)).reshape(nrb, bm, K)
    b32 = (b.T if trans_b else b).float()
    ref = a32.sum(1) @ b32
    scale = a32.abs().sum(1) @ b32.abs()
    bad = torch.any(torch.abs(checks - ref) > ABFT_ATOL + ABFT_RTOL * scale)
    return out, bad
