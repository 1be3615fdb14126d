"""Conv2d entry point and its tile choice; port of
``repro/kernels/conv2d/ops.py``.

Tiles come from the paper's blocking search on the CONV nest, as in the
reference, on the hardware each body runs on.  The bf16 (tensor-core)
body's hierarchy is the H100 as the paper describes an accelerator
(``hw.hopper_levels``: per-PE registers, the shared-memory ring, L2, HBM)
with its PE array (``hw.hopper_array``: 128 pixel rows x a 64-column
filter panel); the paper's optimizer enumerates dataflows (how the pixel
loops ``B``, ``X``, ``Y`` replicate on the array's rows) and runs the
blocking search on each.  The fp32 (CUDA-core) body keeps the (shared
memory, HBM) pair of ``hw.hopper_f32_levels``.  Strided convs go to the
plain oracle, as the reference sends them to its XLA oracle: the kernel is
the paper's stride-1 nest.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import hw
from repro_torch.core.blocking import search_blocking
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.energy import Report
from repro_torch.core.loopnest import conv_nest, divisors
from repro_torch.core.mapper import round_down_pow2, round_up
from repro_torch.core.schedule import ArraySpec, MemLevel
from repro_torch.kernels.conv2d.conv2d import (
    MAX_WARP_TILES,
    STAGE_ALIGN,
    TC_CHUNKS,
    TC_DATA_REGS,
    TC_ROWS,
    WARP_TILE,
    ConvTiles,
    conv2d_cuda,
)
from repro_torch.kernels.conv2d.ref import conv2d_ref

# dataflows the bf16 search runs the blocking search on: the best pixel
# splits by the array's utilization (ties by the input halo per pixel)
DATAFLOWS_SEARCHED = 4


def _align(f: int, n: int, a: int) -> int:
    """The rounding rule for a C or K factor ``f`` of an extent ``n``: the
    largest power of two at most ``f`` and at least the alignment ``a``,
    no more than ``n`` rounded up to ``a``, halved until it divides that.
    With ``a = 1`` it is the reference's rule (``ops.py:50-56``): a power
    of two that divides the extent."""
    n_pad = round_up(n, a)
    b = min(n_pad, round_down_pow2(f, a))
    while n_pad % b:
        b //= 2
    return b


def _fit_f32(t: ConvTiles, Ho: int, Wo: int, FX: int, FY: int) -> ConvTiles:
    """Shrink an aligned fp32 tile until that body takes it: at most
    ``MAX_WARP_TILES`` accumulator tiles (``bk`` halves while it is wider
    than one warp tile, then the pixel tile's larger side steps down to
    the next divisor of its extent), and shared memory, in 4-byte words,
    within ``hw.SMEM_BUDGET_BYTES`` (``bc`` halves, then ``bk``, then the
    pixel tile)."""

    def smaller_pixels(t: ConvTiles) -> ConvTiles:
        if t.bx >= t.by and t.bx > 1:
            return ConvTiles(max(d for d in divisors(Ho) if d < t.bx), t.by, t.bc, t.bk)
        return ConvTiles(t.bx, max(d for d in divisors(Wo) if d < t.by), t.bc, t.bk)

    def half(f: int) -> int:
        return _align(f // 2, f, hw.MMA_ALIGN)

    while True:
        if t.warp_tiles() > MAX_WARP_TILES:
            if t.bk > WARP_TILE:
                t = ConvTiles(t.bx, t.by, t.bc, half(t.bk))
            else:
                t = smaller_pixels(t)
        elif t.smem_bytes(FX, FY, 4) > hw.SMEM_BUDGET_BYTES:
            if t.bc > hw.MMA_ALIGN:
                t = ConvTiles(t.bx, t.by, half(t.bc), t.bk)
            elif t.bk > hw.MMA_ALIGN:
                t = ConvTiles(t.bx, t.by, t.bc, half(t.bk))
            elif t.bx * t.by > 1:
                t = smaller_pixels(t)
            else:
                raise ValueError(f"no conv tile fits shared memory for filter {FX}x{FY}")
        else:
            return t


@dataclasses.dataclass(frozen=True)
class ConvChoice:
    """The bf16 body's tile and the search result it came from: ``report``
    is the paper's model on the chosen dataflow and blocking (its
    schedule's per-level factors, spatial unrolling and utilization)."""

    tiles: ConvTiles
    report: Report


def _pixel_splits(B: int, Ho: int, Wo: int) -> list[tuple[int, int, int]]:
    """(B, X, Y) factors unrolled on the array's ``TC_ROWS`` pixel rows,
    best first: by the array's utilization over the layer (rows used,
    edges padded), then by the input pixels each output pixel loads (the
    halo of a 3x3 window)."""
    cands = []
    for ys in range(1, min(Wo, TC_ROWS) + 1):
        for xs in range(1, min(Ho, TC_ROWS // ys) + 1):
            for bs in range(1, min(B, TC_ROWS // (xs * ys)) + 1):
                padded = (-(-B // bs) * bs) * (-(-Ho // xs) * xs) * (-(-Wo // ys) * ys)
                util = B * Ho * Wo / padded * bs * xs * ys / TC_ROWS
                halo = (xs + 2) * (ys + 2) / (xs * ys)
                cands.append((-util, halo, bs, xs, ys))
    cands.sort()
    return [(bs, xs, ys) for _, _, bs, xs, ys in cands]


def _kernel_filter(FX: int, FY: int, split: tuple[int, int, int], panels: int):
    """The bf16 body's limits as a tile filter for ``search_blocking`` on
    ``hw.hopper_levels()`` (levels REG 0, SMEM 1, L2 2, HBM 3): the grid
    (HBM) splits only pixels and output channels, never C (no reduction
    across blocks) or the filter window; the block's pixel tile is the
    array's (no pixel factor inside it); the L2 level streams only C
    steps, each step (SMEM) ``bc`` channels of the whole window, ``bc`` one
    TMA swizzle span (16, 32 or 64 channels); the output channels stay in
    the registers, ``panels`` 64-column panels of them (at most
    ``hw.WGMMA_MAX_N`` columns), beside a tap's A fragments within
    ``TC_DATA_REGS``; two stages fit the ring."""
    nb, bx, by = split

    def keep(level: int, f: dict, inner: dict) -> bool:
        if level == 3:
            return (f["C"] == f["FX"] == f["FY"] == 1 and inner["K"] == panels
                    and inner["B"] == inner["X"] == inner["Y"] == 1)
        if level == 2:
            if any(v > 1 for d, v in f.items() if d != "C") or inner["C"] not in TC_CHUNKS:
                return False
            t = ConvTiles(bx, by, inner["C"], hw.CONV_PANEL * inner["K"], nb,
                          hw.CONV_RING_STAGES[0])
            return (t.ring_bytes(FX, FY) <= hw.SMEM_PER_BLOCK_BYTES
                    and t.data_regs() <= TC_DATA_REGS)
        if level == 1:
            return f["B"] == f["X"] == f["Y"] == f["K"] == 1
        return True

    return keep


@functools.lru_cache(maxsize=256)
def conv_search(B: int, Ho: int, Wo: int, C: int, K: int, FX: int, FY: int) -> ConvChoice:
    """The bf16 body's tile by the paper's optimizer: for each of the
    ``DATAFLOWS_SEARCHED`` best pixel dataflows and each width of the
    register tile (1-4 panels of 64 output channels), the blocking search
    on the whole layer (batch ``B``) over ``hw.hopper_levels()`` with the
    kernel's limits as its tile filter.  The paper's model times one array;
    the card has ``hw.SM_COUNT`` of them, each taking the grid's tiles in
    turn (the kernel is persistent), so a choice takes ``ceil(tiles / SMs)``
    tile times of the model's cycles.  The best by that time, then by the
    model's energy.  C is padded to the tensor cores' depth of 16 (TMA's
    zero fill).  The block tile is the schedule's cumulative tile at the
    SMEM level with the array's unrolling; the ring takes as many stages as
    fit, up to 4.  Raises if no tile fits the kernel."""
    nest = conv_nest("conv", B=B, K=K, C=round_up(C, hw.WGMMA_K), X=Ho, Y=Wo, FX=FX, FY=FY)
    max_panels = min(hw.WGMMA_MAX_N, round_up(K, hw.CONV_PANEL)) // hw.CONV_PANEL
    best = None
    for split in _pixel_splits(B, Ho, Wo)[:DATAFLOWS_SEARCHED]:
        rows = tuple((d, f) for d, f in zip("YXB", split[::-1]) if f > 1)
        flow = Dataflow(assigns=(rows, (("K", hw.CONV_PANEL),)))
        for panels in range(1, max_panels + 1):
            try:
                rep = search_blocking(nest, hw.hopper_levels(), hw.hopper_array(), flow, beam=8,
                                      tile_filter=_kernel_filter(FX, FY, split, panels)).best
            except ValueError:
                continue
            t = ConvTiles(split[1], split[2], 1, hw.CONV_PANEL * panels, split[0])
            tiles = t.grid(B, Ho, Wo, K)
            key = (-(-tiles // hw.SM_COUNT) * rep.cycles / tiles, rep.energy_pj)
            if best is None or key < best[0]:
                best = (key, rep, split)
    if best is None:
        raise ValueError(f"no conv tile fits the tensor-core kernel: B={B} Ho={Ho} Wo={Wo} "
                         f"C={C} K={K} filter {FX}x{FY}")
    _, rep, (nb, bx, by) = best
    tile = rep.schedule.cum_tile(1, include_spatial=True)
    t = ConvTiles(bx, by, tile["C"], tile["K"], nb, 1)
    stages = min(hw.CONV_RING_STAGES[1],
                 (hw.SMEM_PER_BLOCK_BYTES - STAGE_ALIGN) // (t.stage_bytes(FX, FY) + 16))
    return ConvChoice(dataclasses.replace(t, stages=stages), rep)


@functools.lru_cache(maxsize=256)
def choose_conv_blocks(
    B: int, Ho: int, Wo: int, C: int, K: int, FX: int, FY: int,
    levels: tuple[MemLevel, ...] | None = None, word_bytes: int = 2,
) -> ConvTiles:
    """Run the blocking search on the conv nest and return the block tile.

    Without ``levels`` the tile is for the CUDA kernel: for bf16
    (``word_bytes`` 2) the tensor-core body's tile from :func:`conv_search`;
    for fp32 (``word_bytes`` 4) the CUDA-core body's, from the search on
    ``hw.hopper_f32_levels()`` (B = 1, as in the reference), ``bc`` and
    ``bk`` rounded by :func:`_align` to 16 and fitted by :func:`_fit_f32`.
    With the reference's TPU ``levels`` the search's C and K factors are
    rounded by the same rule at alignment 1 (a power of two dividing the
    extent), which is the reference's ``(bc, bk)``; X and Y are the
    search's factors as they are."""
    if levels is None and word_bytes == 2:
        return conv_search(B, Ho, Wo, C, K, FX, FY).tiles
    nest = conv_nest("conv", B=1, K=K, C=C, X=Ho, Y=Wo, FX=FX, FY=FY)
    try:
        res = search_blocking(
            nest, levels or hw.hopper_f32_levels(), ArraySpec(dims=(1,)),
            Dataflow(assigns=((),)), beam=8,
        )
        tile = res.best.schedule.cum_tile(0, include_spatial=False)
        bx, by, bc, bk = tile["X"], tile["Y"], tile["C"], tile["K"]
    except ValueError:  # nothing fits: the reference's fallback, whole image
        bx, by, bc, bk = Ho, Wo, 128, 128
    if levels is not None:
        return ConvTiles(bx, by, _align(bc, C, 1), _align(bk, K, 1))
    t = ConvTiles(bx, by, _align(bc, C, hw.MMA_ALIGN), _align(bk, K, hw.MMA_ALIGN))
    return _fit_f32(t, Ho, Wo, FX, FY)


def conv2d(
    x: torch.Tensor,      # (B, H_in, W_in, C)
    w: torch.Tensor,      # (FX, FY, C, K)
    stride: int = 1,
) -> torch.Tensor:
    """Valid NHWC conv: the CUDA kernel wrapper on the searched tiles (it
    takes the plain version only for CPU tensors); stride != 1 goes to the
    plain oracle, as the reference routes it."""
    if stride != 1:
        return conv2d_ref(x, w, stride=stride)
    B, H, W, C = x.shape
    FX, FY, _, K = w.shape
    tiles = choose_conv_blocks(B, H - FX + 1, W - FY + 1, C, K, FX, FY,
                               word_bytes=x.element_size())
    return conv2d_cuda(x, w, tiles)
