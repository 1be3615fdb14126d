"""Public GEMM entry points; port of ``repro/kernels/matmul/ops.py``.

The reference pads to mapper-chosen tile multiples and slices back; the
CUDA kernels mask their ragged edges and use fixed tiles, so :func:`matmul`
is the kernel wrapper itself (the Hopper tile search is ROADMAP A6), and
:func:`matmul_abft` adds the checksum verdict around the checksum GEMM."""

from __future__ import annotations

import torch

from repro_torch.kernels.abft import ABFT_ATOL, ABFT_RTOL
from repro_torch.kernels.matmul.matmul import abft_block_rows, matmul_abft_cuda, matmul_cuda


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
