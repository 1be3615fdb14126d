"""Public GEMM entry point; port of ``repro/kernels/matmul/ops.py:25``.

The reference pads to mapper-chosen tile multiples and slices back; the
CUDA kernel masks its ragged edges and uses fixed tiles, so this is the
kernel wrapper itself (the Hopper tile search is ROADMAP A6)."""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul.matmul import matmul_cuda


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    """General (M, K) x (K, N) (or x (N, K)^T with ``trans_b``) -> (M, N)."""
    return matmul_cuda(a, b, trans_b=trans_b)
