"""Direct conv2d: the CUDA kernel wrapper and its plain version.

:func:`conv2d_cuda` replaces the TPU kernel ``conv2d_pallas``
(``repro/kernels/conv2d/conv2d.py``), the paper's Algorithm-1 CONV nest as
a valid, stride-1 NHWC convolution with an fp32 accumulator, with
``kernels/csrc/conv2d.cu``: one block per (image, ``bx x by`` output pixel
tile, ``bk`` output channels), the reduction over ``bc``-channel steps of
C, then the first filter axis (H), then the second (W).  Its tile is a
:class:`ConvTiles` that ``ops.choose_conv_blocks`` takes from the paper's
blocking search on the H100's (shared memory, HBM) hierarchy.  It takes
bf16 operands (tensor cores) or fp32 operands (CUDA cores, full fp32, no
TF32) and raises for any other dtype.

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

from repro_torch.hw import MMA_ALIGN
from repro_torch.kernels import _build

# The kernel's shape, as csrc/conv2d.cu fixes it: 8 warps, each holding at
# most two 32 x 32 (pixels x output channels) fp32 accumulator tiles, so a
# block's output tile is at most 16 warp tiles; shared-memory rows are
# padded by 8 bf16 so ldmatrix reads them without bank conflicts.
WARP_TILE = 32
MAX_WARP_TILES = 16
SMEM_ROW_PAD = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"conv2d": [_P] * 3 + [_I] * 12 + [_P]}
DTYPES = (torch.bfloat16, torch.float32)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvTiles:
    """One block's tile of the CONV nest: ``bx x by`` output pixels (``bx``
    along H, the nest's X; ``by`` along W, its Y), ``bc`` input channels per
    reduction step and ``bk`` output channels."""

    bx: int
    by: int
    bc: int
    bk: int

    def smem_bytes(self, FX: int, FY: int, word_bytes: int = 2) -> int:
        """Shared memory the kernel stages per block: the haloed input tile
        and the ``FX x FY x bc`` filter slice of ``bk`` output channels
        (rounded up to whole warp tiles), rows padded as the kernel pads
        them, in words of ``word_bytes`` (2 for bf16, 4 for fp32)."""
        inp = (self.bx + FX - 1) * (self.by + FY - 1) * (self.bc + SMEM_ROW_PAD)
        bkp = _ceil_div(self.bk, WARP_TILE) * WARP_TILE
        return word_bytes * (inp + FX * FY * self.bc * (bkp + SMEM_ROW_PAD))

    def warp_tiles(self) -> int:
        """32 x 32 accumulator tiles that cover the block's output tile."""
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
    if (min(tiles.bx, tiles.by) < 1 or tiles.bc < 1 or tiles.bk < 1
            or tiles.bc % MMA_ALIGN or tiles.bk % MMA_ALIGN):
        raise ValueError(f"tiles {tiles}: bc and bk must be positive multiples of {MMA_ALIGN}")
    if tiles.warp_tiles() > MAX_WARP_TILES:
        raise ValueError(f"tiles {tiles}: more than {MAX_WARP_TILES} warp tiles per block")


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
    lib = _build.library("conv2d", _SIGS)
    err = lib.conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, C, K, FX, FY,
        tiles.bx, tiles.by, tiles.bc, tiles.bk, int(x.dtype == torch.float32),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "conv2d")
    conv2d_cuda.launches += 1
    return out


conv2d_cuda.launches = 0
