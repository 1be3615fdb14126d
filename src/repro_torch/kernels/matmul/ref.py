"""Plain oracle for the blocked matmul kernel; port of
``repro/kernels/matmul/ref.py``."""

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """fp32 product of the operands, cast to ``out_dtype`` (default a's)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
