"""Plain oracle for the WKV-6 kernel; port of
``repro/kernels/linear_scan/ref.py`` (``wkv6_ref``).  The diagonal scan's
oracle comes with the recurrentgemma slice."""

from __future__ import annotations

import torch


def wkv6_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, (B, H, T, D) layout; returns (out, s_T)."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + u[..., None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=2), s
