"""Linear-scan entry points; port of ``repro/kernels/linear_scan/ops.py``.
The reference jit-wraps its Pallas calls and interprets them off the TPU;
here each entry point is its kernel's wrapper, which takes the plain
version only for CPU tensors.  The reference's ``bd`` (the TPU's channel
block) has no counterpart: the CUDA scan gives every channel its own
thread."""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.linear_scan import linear_scan_cuda, wkv6_cuda


def linear_scan(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + x_t`` over axis 1 of (B, T, D) fp32 tensors
    from ``h0`` (B, D): returns (out (B, T, D), h_T); ``inplace`` writes
    h_T into ``h0``."""
    return linear_scan_cuda(a, x, h0, inplace=inplace)


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence over (B, H, T, D) streams from state ``s0``
    (B, H, D, D): returns (out (B, H, T, D), s_T); ``inplace`` writes s_T
    into ``s0``."""
    return wkv6_cuda(r, k, v, w, u, s0, inplace=inplace)
