"""Conv2d entry point and its tile choice; port of
``repro/kernels/conv2d/ops.py``.

Tiles come from the paper's blocking search on the CONV nest, as in the
reference, but on the H100's (shared memory, HBM) hierarchy
(``hw.hopper_levels``) and for a kernel that also tiles the output pixels:
the level-0 X, Y, C and K factors of the search become the block's
``(bx, by, bc, bk)``.  Strided convs go to the plain oracle, as the
reference sends them to its XLA oracle: the kernel is the paper's stride-1
nest.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import hw
from repro_torch.core.blocking import search_blocking
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.loopnest import conv_nest, divisors
from repro_torch.core.mapper import round_down_pow2, round_up
from repro_torch.core.schedule import ArraySpec, MemLevel
from repro_torch.kernels.conv2d.conv2d import (
    MAX_WARP_TILES,
    WARP_TILE,
    ConvTiles,
    conv2d_cuda,
)
from repro_torch.kernels.conv2d.ref import conv2d_ref


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


def _fit(t: ConvTiles, Ho: int, Wo: int, FX: int, FY: int, word_bytes: int) -> ConvTiles:
    """Shrink an aligned tile until the kernel takes it: at most
    ``MAX_WARP_TILES`` accumulator tiles (``bk`` halves while it is wider
    than one warp tile, then the pixel tile's larger side steps down to
    the next divisor of its extent), and shared memory, in words of
    ``word_bytes``, within ``hw.SMEM_BUDGET_BYTES`` (``bc`` halves, then
    ``bk``, then the pixel tile)."""

    def smaller_pixels(t: ConvTiles) -> ConvTiles:
        if t.bx >= t.by and t.bx > 1:
            return ConvTiles(max(d for d in divisors(Ho) if d < t.bx), t.by, t.bc, t.bk)
        return ConvTiles(t.bx, max(d for d in divisors(Wo) if d < t.by), t.bc, t.bk)

    def half(f: int, n: int) -> int:
        return _align(f // 2, n, hw.MMA_ALIGN)

    while True:
        if t.warp_tiles() > MAX_WARP_TILES:
            if t.bk > WARP_TILE:
                t = ConvTiles(t.bx, t.by, t.bc, half(t.bk, t.bk))
            else:
                t = smaller_pixels(t)
        elif t.smem_bytes(FX, FY, word_bytes) > hw.SMEM_BUDGET_BYTES:
            if t.bc > hw.MMA_ALIGN:
                t = ConvTiles(t.bx, t.by, half(t.bc, t.bc), t.bk)
            elif t.bk > hw.MMA_ALIGN:
                t = ConvTiles(t.bx, t.by, t.bc, half(t.bk, t.bk))
            elif t.bx * t.by > 1:
                t = smaller_pixels(t)
            else:
                raise ValueError(f"no conv tile fits shared memory for filter {FX}x{FY}")
        else:
            return t


@functools.lru_cache(maxsize=256)
def choose_conv_blocks(
    B: int, Ho: int, Wo: int, C: int, K: int, FX: int, FY: int,
    levels: tuple[MemLevel, ...] | None = None, word_bytes: int = 2,
) -> ConvTiles:
    """Run the blocking search on the conv nest (B = 1, as in the
    reference) and return the block tile.

    Without ``levels`` the tile is for the CUDA kernel: the search runs on
    ``hw.hopper_levels()``, ``bc`` and ``bk`` are rounded by :func:`_align`
    to the MMA alignment (16; C = 3 is zero-padded to 16 in shared memory,
    ragged edges are masked), and :func:`_fit` shrinks the tile to what
    the kernel takes, its shared memory reckoned in words of ``word_bytes``
    (2 for the bf16 kernel, 4 for the fp32 one; the search itself counts
    the paper's 16-bit words).  With the reference's TPU ``levels`` the search's
    C and K factors are rounded by the same rule at alignment 1 (a power of
    two dividing the extent), which is the reference's ``(bc, bk)``; X and
    Y are the search's factors as they are."""
    nest = conv_nest("conv", B=1, K=K, C=C, X=Ho, Y=Wo, FX=FX, FY=FY)
    try:
        res = search_blocking(
            nest, levels or hw.hopper_levels(), ArraySpec(dims=(1,)),
            Dataflow(assigns=((),)), beam=8,
        )
        tile = res.best.schedule.cum_tile(0, include_spatial=False)
        bx, by, bc, bk = tile["X"], tile["Y"], tile["C"], tile["K"]
    except ValueError:  # nothing fits: the reference's fallback, whole image
        bx, by, bc, bk = Ho, Wo, 128, 128
    if levels is not None:
        return ConvTiles(bx, by, _align(bc, C, 1), _align(bk, K, 1))
    t = ConvTiles(bx, by, _align(bc, C, hw.MMA_ALIGN), _align(bk, K, hw.MMA_ALIGN))
    return _fit(t, Ho, Wo, FX, FY, word_bytes)


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
