"""Dense-softmax oracles for ragged decode attention; port of
``repro/kernels/flash_attention/ref.py`` (l.39-86)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _masked_softmax_pv(q, k, v, live):
    d = q.shape[-1]
    s = torch.einsum("bhgd,bshd->bhgs", q, k).float() / math.sqrt(d)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype), v).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # (B, KV, G, d)
    k: torch.Tensor,        # (B, S, KV, d)
    v: torch.Tensor,        # (B, S, KV, d)
    lengths: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    """Row b attends over exactly cache slots [0, lengths[b]); a length of
    0 is a fully masked row here (the kernels clamp it to 1)."""
    idx = torch.arange(k.shape[1], device=k.device)
    return _masked_softmax_pv(q, k, v, idx[None, :] < lengths[:, None])


def decode_attention_paged_ref(
    q: torch.Tensor,        # (B, KV, G, d)
    kpool: torch.Tensor,    # (num_blocks, bs, KV, d)
    vpool: torch.Tensor,    # (num_blocks, bs, KV, d)
    tables: torch.Tensor,   # (B, n_blk) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Gather each row's logical KV sequence through its block table, then
    the dense masked softmax (logical index == position; optional window)."""
    B, n_blk = tables.shape
    bs = kpool.shape[1]
    k = kpool[tables.long()].reshape(B, n_blk * bs, *kpool.shape[2:])
    v = vpool[tables.long()].reshape(B, n_blk * bs, *vpool.shape[2:])
    idx = torch.arange(k.shape[1], device=k.device)[None, :]
    live = idx < lengths[:, None]
    if window is not None:
        live &= idx > (lengths[:, None] - 1 - window)
    return _masked_softmax_pv(q, k, v, live)
