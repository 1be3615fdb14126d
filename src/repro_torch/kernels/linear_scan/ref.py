"""Plain oracles for the linear-scan kernels; port of
``repro/kernels/linear_scan/ref.py``."""

from __future__ import annotations

import torch


def linear_scan_ref(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + x_t over axis 1; returns (outs, h_T)."""
    h = h0
    outs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        outs.append(h)
    out = torch.stack(outs, dim=1) if outs else torch.empty_like(a)
    return out, h


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
