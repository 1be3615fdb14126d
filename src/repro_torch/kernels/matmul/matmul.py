"""Tiled GEMM: the CUDA kernel wrappers and their plain versions.

:func:`matmul_cuda` replaces the TPU kernel ``matmul_pallas``
(``repro/kernels/matmul/matmul.py``) with ``kernels/csrc/matmul.cu``: fp32
accumulation, stored in the operands' type, ragged edges masked inside
the kernel (no padding copies), and B taken as ``(K, N)`` or, with
``trans_b``, as ``(N, K)`` so the tied unembedding reads the embedding
table in place.  bf16 operands run on the tensor cores; fp32 operands on
the CUDA cores in full fp32 (no TF32), each output summed over k in
order, so a row's bits do not depend on M in either type.  Tiles are
fixed Hopper-sized constants (16x64 for M <= 16, else 64x64).

:func:`matmul_plain` is its plain version: the fp32 product cast to the
input dtype (the reference's ``matmul_ref``).  The wrapper runs it only
for CPU tensors; a CUDA tensor launches the kernel or raises.

:func:`matmul_abft_cuda` replaces ``matmul_pallas_abft`` with the same
kernel plus a checksum epilogue (``gemm_abft``): it also returns the
column sums ``e^T·C`` of every row block of :func:`abft_block_rows` rows,
summed from the fp32 accumulator before the cast, as a
``(ceil(M/bm), N)`` fp32 tensor.  Its product is bitwise
:func:`matmul_cuda`'s.  :func:`matmul_abft_plain` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "gemm": [_P] * 3 + [_I] * 5 + [_P],
    "gemm_abft": [_P] * 4 + [_I] * 5 + [_P],
}
DTYPES = (torch.bfloat16, torch.float32)


def abft_block_rows(M: int) -> int:
    """Rows per checksum block: the kernel's row tile for this M."""
    return 16 if M <= 16 else 64


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    return matmul_ref(a, b.T if trans_b else b)


def matmul_abft_plain(
    a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`matmul_abft_cuda`: the fp32 product cast to
    the input dtype, and the column sums of the fp32 product over every
    :func:`abft_block_rows`-row block (the last block is ragged: missing
    rows add nothing)."""
    M = a.shape[0]
    bm = abft_block_rows(M)
    acc = a.float() @ (b.T if trans_b else b).float()
    nrb = -(-M // bm)
    padded = torch.nn.functional.pad(acc, (0, 0, 0, nrb * bm - M))
    return acc.to(a.dtype), padded.reshape(nrb, bm, -1).sum(1)


def _check_operands(a: torch.Tensor, b: torch.Tensor, trans_b: bool) -> tuple[int, int, int]:
    """Raise on what the GEMM kernels do not take; returns (M, N, K)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul needs both operands on one CUDA device: {a.device}, {b.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {a.device}, not the current CUDA device")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"kernel takes two bf16 or two fp32 operands, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"kernel takes contiguous 2-D operands: {a.shape}, {b.shape}")
    M, K = a.shape
    N, Kb = (b.shape if trans_b else b.shape[::-1])
    if K != Kb:
        raise ValueError(f"inner dims differ: a {a.shape}, b {b.shape}, trans_b={trans_b}")
    return M, N, K


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N), or (M, K) @ (N, K)^T with ``trans_b``, -> (M, N)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, trans_b=trans_b)
    M, N, K = _check_operands(a, b, trans_b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library("matmul", _SIGS)
    err = lib.gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(trans_b),
        int(a.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "gemm")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0


def matmul_abft_cuda(
    a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`matmul_cuda` plus the fp32 column checksums of every
    :func:`abft_block_rows`-row block: ``(out (M, N), checks (ceil(M/bm), N))``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_abft_plain(a, b, trans_b=trans_b)
    M, N, K = _check_operands(a, b, trans_b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    checks = torch.empty(
        (-(-M // abft_block_rows(M)), N), dtype=torch.float32, device=a.device
    )
    if M == 0 or N == 0:
        return out, checks
    lib = _build.library("matmul", _SIGS)
    err = lib.gemm_abft(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), checks.data_ptr(), M, N, K,
        int(trans_b), int(a.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "gemm_abft")
    matmul_abft_cuda.launches += 1
    return out, checks


matmul_abft_cuda.launches = 0
