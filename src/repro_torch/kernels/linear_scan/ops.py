"""WKV-6 entry point; port of the ``wkv6`` half of
``repro/kernels/linear_scan/ops.py``.  The reference jit-wraps its Pallas
call and interprets it off the TPU; here the entry point is the kernel
wrapper, which takes the plain version only for CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.linear_scan import wkv6_cuda


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence over (B, H, T, D) streams from state ``s0``
    (B, H, D, D): returns (out (B, H, T, D), s_T); ``inplace`` writes s_T
    into ``s0``."""
    return wkv6_cuda(r, k, v, w, u, s0, inplace=inplace)
