"""Direct conv2d: the CUDA kernel wrapper and its plain version.

:func:`conv2d_cuda` replaces the TPU kernel ``conv2d_pallas``
(``repro/kernels/conv2d/conv2d.py``), the paper's Algorithm-1 CONV nest as
a valid, stride-1 NHWC convolution with an fp32 accumulator, with
``kernels/csrc/conv2d.cu``.  bf16 operands run its tensor-core body: one
block per (``nb`` images x ``bx x by`` output pixels, ``bk`` output
channels), a producer thread feeding a TMA ring of ``stages`` bc-channel
steps, two consumer warpgroups running ``wgmma`` on the 128 x ``bk``
output tile in registers.  fp32 operands run its CUDA-core body (full
fp32, no TF32).  The tiles are :class:`ConvTiles` that
``ops.choose_conv_blocks`` takes from the paper's blocking search.  Any
other dtype raises.

:func:`conv2d_plain` is its plain version, in the TPU kernel's order: C
blocks outermost, then the two filter axes, each step one fp32
``(pixels, bc) @ (bc, K)`` product added to an fp32 accumulator, cast once
at the end (the TPU kernel's ``bk`` blocks split output columns, which are
independent, so one product covers them all).  The wrapper runs it only
for CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import hw
from repro_torch.kernels import _build

# The tensor-core body's shape, as csrc/conv2d.cu fixes it: 128 output
# pixels a block (two consumer warpgroups of 64 rows), output channels in
# 64-column panels (one to four), input channels in steps of 16, 32 or 64
# (one TMA swizzle span of 32, 64 or 128 bytes), 2-4 ring stages, each
# aligned to 1024 bytes.
TC_ROWS = hw.CONV_CONSUMER_WARPGROUPS * hw.WGMMA_M
TC_CHUNKS = (16, 32, 64)
STAGE_ALIGN = 1024
# registers a consumer thread may give its accumulators and A fragments:
# 168 a thread at 384 threads a block, less 32 for addresses and loop state
# (past it ptxas serialises the wgmmas)
TC_DATA_REGS = 136

# The fp32 body's shape: 8 warps, each holding at most two 32 x 32 (pixels
# x output channels) fp32 accumulator tiles, so a block's output tile is
# at most 16 warp tiles; shared-memory rows are padded by 8 words.
WARP_TILE = 32
MAX_WARP_TILES = 16
SMEM_ROW_PAD = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"conv2d_bf16": [_P] * 3 + [_I] * 15 + [_P],
         "conv2d_f32": [_P] * 3 + [_I] * 11 + [_P]}
DTYPES = (torch.bfloat16, torch.float32)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class ConvTiles:
    """One block's tile of the CONV nest: ``nb`` images of ``bx x by``
    output pixels (``bx`` along H, the nest's X; ``by`` along W, its Y),
    ``bc`` input channels per reduction step and ``bk`` output channels;
    ``stages`` is the tensor-core body's ring depth (the fp32 body takes
    one image a block and one stage)."""

    bx: int
    by: int
    bc: int
    bk: int
    nb: int = 1
    stages: int = 1

    # -- the tensor-core (bf16) body --
    def rows(self) -> int:
        """Output pixels of one block."""
        return self.nb * self.bx * self.by

    def stage_bytes(self, FX: int, FY: int) -> int:
        """One ring stage: the haloed input tile (padded to 1024 bytes) and
        ``bk / 64`` filter panels of ``FX FY bc`` rows of 128 bytes."""
        inp = 2 * self.nb * (self.bx + FX - 1) * (self.by + FY - 1) * self.bc
        return _round_up(inp, STAGE_ALIGN) + self.bk // hw.CONV_PANEL * FX * FY * self.bc * 128

    def ring_bytes(self, FX: int, FY: int) -> int:
        """Shared memory a launch asks for: the stages, 1 KB to align them
        and two 8-byte barriers per stage."""
        return self.stages * self.stage_bytes(FX, FY) + STAGE_ALIGN + 16 * self.stages

    def data_regs(self) -> int:
        """Registers a consumer thread holds for the tile: ``bk / 2`` fp32
        accumulators and one tap's A fragments (4 a 16-channel step), two
        sets where ``bk`` is at most 128."""
        sets = 2 if self.bk <= 2 * hw.CONV_PANEL else 1
        return self.bk // 2 + 4 * (self.bc // 16) * sets

    def grid(self, B: int, Ho: int, Wo: int, K: int) -> int:
        """Blocks of one launch."""
        return (_ceil_div(B, self.nb) * _ceil_div(Ho, self.bx) * _ceil_div(Wo, self.by)
                * _ceil_div(K, self.bk))

    def utilization(self, B: int, Ho: int, Wo: int, K: int) -> float:
        """Useful outputs over the outputs the blocks' MMAs compute (each
        block ``TC_ROWS`` x ``bk``), ragged edge tiles included."""
        return B * Ho * Wo * K / (self.grid(B, Ho, Wo, K) * TC_ROWS * self.bk)

    # -- the fp32 body --
    def smem_bytes(self, FX: int, FY: int, word_bytes: int = 4) -> int:
        """Shared memory the fp32 body stages per block: the haloed input
        tile and the ``FX x FY x bc`` filter slice of ``bk`` output channels
        (rounded up to whole warp tiles), rows padded as the kernel pads
        them, in words of ``word_bytes``."""
        inp = (self.bx + FX - 1) * (self.by + FY - 1) * (self.bc + SMEM_ROW_PAD)
        bkp = _ceil_div(self.bk, WARP_TILE) * WARP_TILE
        return word_bytes * (inp + FX * FY * self.bc * (bkp + SMEM_ROW_PAD))

    def warp_tiles(self) -> int:
        """32 x 32 accumulator tiles that cover the fp32 body's output tile."""
        return _ceil_div(self.bx * self.by, WARP_TILE) * _ceil_div(self.bk, WARP_TILE)


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, tiles: ConvTiles) -> torch.Tensor:
    B, H, W, C = x.shape
    FX, FY, _, K = w.shape
    Ho, Wo = H - FX + 1, W - FY + 1
    acc = torch.zeros((B * Ho * Wo, K), dtype=torch.float32, device=x.device)
    for c0 in range(0, C, tiles.bc):
        c1 = min(C, c0 + tiles.bc)
        for i in range(FX):
            for j in range(FY):
                win = x[:, i : i + Ho, j : j + Wo, c0:c1].reshape(-1, c1 - c0)
                acc.addmm_(win.float(), w[i, j, c0:c1].float())
    return acc.reshape(B, Ho, Wo, K).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, tiles: ConvTiles) -> None:
    """Raise on what the kernel does not take."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv2d needs both operands on one CUDA device: {x.device}, {w.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {x.device}, not the current CUDA device")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"kernel takes two bf16 or two fp32 operands, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"kernel takes contiguous NHWC x and HWIO w: {x.shape}, {w.shape}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"channels differ: x {x.shape}, w {w.shape}")
    if x.shape[1] < w.shape[0] or x.shape[2] < w.shape[1]:
        raise ValueError(f"filter {w.shape[:2]} larger than the image {x.shape[1:3]}")
    if x.dtype == torch.float32:
        if (min(tiles.bx, tiles.by) < 1 or tiles.bc < 1 or tiles.bk < 1 or tiles.nb != 1
                or tiles.bc % hw.MMA_ALIGN or tiles.bk % hw.MMA_ALIGN):
            raise ValueError(f"tiles {tiles}: one image, bc and bk positive multiples of "
                             f"{hw.MMA_ALIGN}")
        if tiles.warp_tiles() > MAX_WARP_TILES:
            raise ValueError(f"tiles {tiles}: more than {MAX_WARP_TILES} warp tiles per block")
        return
    FX, FY = w.shape[:2]
    lo, hi = hw.CONV_RING_STAGES
    if (min(tiles.nb, tiles.bx, tiles.by) < 1 or tiles.rows() > TC_ROWS
            or tiles.bc not in TC_CHUNKS or tiles.bk % hw.CONV_PANEL
            or not hw.CONV_PANEL <= tiles.bk <= hw.WGMMA_MAX_N or not lo <= tiles.stages <= hi):
        raise ValueError(f"tiles {tiles}: at most {TC_ROWS} pixels, bc in {TC_CHUNKS}, bk a "
                         f"multiple of {hw.CONV_PANEL} up to {hw.WGMMA_MAX_N}, {lo}-{hi} stages")
    if tiles.data_regs() > TC_DATA_REGS:
        raise ValueError(f"tiles {tiles}: {tiles.data_regs()} accumulator and A registers a "
                         f"thread, past {TC_DATA_REGS}")
    if FX * FY > 256 or tiles.bx + FX - 1 > 256 or tiles.by + FY - 1 > 256:
        raise ValueError(f"tiles {tiles}: a TMA box side is past 256 for filter {FX}x{FY}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("TMA needs 16-byte aligned operands: x at "
                         f"{x.data_ptr():#x}, w at {w.data_ptr():#x}")


def _pad_for_tma(x: torch.Tensor, w: torch.Tensor, bc: int) -> tuple:
    """x and w with the row strides TMA can describe (multiples of 16
    bytes) and at least one box of channels: x's channels are padded with
    zeros to a multiple of 8 (and to ``bc`` where C is smaller; w's rows
    with them), w's output channels to a multiple of 8, at least one
    64-column panel.  Returns (x, w, C read by the kernel)."""
    C, K = x.shape[3], w.shape[3]
    Cx = max(_round_up(C, 8), bc)
    Cw = bc if C < bc else C
    Kw = max(_round_up(K, 8), hw.CONV_PANEL)
    if Cx != C:
        x = torch.nn.functional.pad(x, (0, Cx - C))
    if Cw != C or Kw != K:
        w = torch.nn.functional.pad(w, (0, Kw - K, 0, Cw - C))
    return x, w, Cw


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, tiles: ConvTiles) -> torch.Tensor:
    """Valid stride-1 conv: x (B, H, W, C), w (FX, FY, C, K) ->
    (B, H - FX + 1, W - FY + 1, K)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_plain(x, w, tiles)
    _check(x, w, tiles)
    B, H, W, C = x.shape
    FX, FY, _, K = w.shape
    out = torch.empty((B, H - FX + 1, W - FY + 1, K), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream().cuda_stream
    if x.dtype == torch.float32:
        lib = _build.library("conv2d", _SIGS)
        err = lib.conv2d_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, C, K, FX, FY,
                             tiles.bx, tiles.by, tiles.bc, tiles.bk, stream)
    else:
        x, w, Cr = _pad_for_tma(x, w, tiles.bc)
        lib = _build.library("conv2d", _SIGS)
        err = lib.conv2d_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, x.shape[3],
                              Cr, w.shape[3], K, FX, FY, tiles.nb, tiles.bx, tiles.by, tiles.bc,
                              tiles.bk, tiles.stages, stream)
    _build.check(err, "conv2d")
    conv2d_cuda.launches += 1
    return out


conv2d_cuda.launches = 0
