"""Tiled bf16 GEMM: the CUDA kernel wrapper and its plain version.

:func:`matmul_cuda` replaces the TPU kernel ``matmul_pallas``
(``repro/kernels/matmul/matmul.py``) with ``kernels/csrc/matmul.cu``: fp32
accumulation, bf16 store, ragged edges masked inside the kernel (no
padding copies), and B taken as ``(K, N)`` or, with ``trans_b``, as
``(N, K)`` so the tied unembedding reads the embedding table in place.
Tiles are fixed Hopper-sized constants (16x64 for M <= 16, else 64x64,
K steps of 32).

:func:`matmul_plain` is its plain version: the fp32 product cast to the
input dtype (the reference's ``matmul_ref``).  The wrapper runs it only
for CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"gemm_bf16": [_P] * 3 + [_I] * 4 + [_P]}


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    return matmul_ref(a, b.T if trans_b else b)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N), or (M, K) @ (N, K)^T with ``trans_b``, -> (M, N)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, trans_b=trans_b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul needs both operands on one CUDA device: {a.device}, {b.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {a.device}, not the current CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"kernel takes bf16 operands, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"kernel takes contiguous 2-D operands: {a.shape}, {b.shape}")
    M, K = a.shape
    N, Kb = (b.shape if trans_b else b.shape[::-1])
    if K != Kb:
        raise ValueError(f"inner dims differ: a {a.shape}, b {b.shape}, trans_b={trans_b}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library("matmul", _SIGS)
    err = lib.gemm_bf16(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(trans_b),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "gemm_bf16")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
