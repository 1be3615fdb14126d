"""Decode-attention entry points; port of the decode half of
``repro/kernels/flash_attention/ops.py`` (l.137-240).

``impl``: None runs the CUDA kernel wrapper (which takes the plain version
only for CPU tensors); "plain" runs the plain version on any device, the
oracle substrate of ``KernelConfig(attention="xla")`` engines.  The
reference's G -> 8 query padding exists only for the TPU's sublanes and is
not ported.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.decode_attention import (
    decode_attention_paged_plain,
    decode_attention_plain,
    flash_decode_cuda,
    flash_decode_paged_cuda,
)


def _pick_decode_bk(S: int) -> int:
    """KV split for contiguous decode: the largest divisor of the cache
    extent S that is at most 64, so the cache is never padded and the
    ragged skip stays fine-grained.  (The Hopper tile search is ROADMAP
    A6.)"""
    b = max(1, min(64, S))
    while S % b:
        b -= 1
    return b


def _check_impl(impl: str | None) -> None:
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None (kernel) or 'plain': {impl!r}")


def decode_attention(
    q: torch.Tensor,        # (B, KV, G, d) one query token per slot
    k: torch.Tensor,        # (B, S, KV, d) cache-native layout
    v: torch.Tensor,        # (B, S, KV, d)
    lengths: torch.Tensor,  # (B,) int32 live KV slots per row
    *,
    bk: int | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Ragged flash-decoding over a contiguous cache; returns (B, KV, G, d).
    ``bk`` is clamped to a divisor of S (None = :func:`_pick_decode_bk`)."""
    _check_impl(impl)
    S = k.shape[1]
    bk_ = _pick_decode_bk(S) if bk is None else max(1, min(bk, S))
    while S % bk_:
        bk_ -= 1
    if impl == "plain":
        return decode_attention_plain(q, k, v, lengths, bk=bk_)
    return flash_decode_cuda(q, k, v, lengths, bk=bk_)


def decode_attention_paged(
    q: torch.Tensor,        # (B, KV, G, d) one query token per row
    kpool: torch.Tensor,    # (num_blocks, bs, KV, d) shared block pool
    vpool: torch.Tensor,    # (num_blocks, bs, KV, d)
    tables: torch.Tensor,   # (B, n_blk) int32 logical -> physical block
    lengths: torch.Tensor,  # (B,) int32 live tokens per row
    *,
    window: int | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Block-table-indirect ragged flash-decoding; returns (B, KV, G, d).
    The KV split is the pool's block size, so the logical reduction order
    matches the contiguous path at ``bk == block_size``."""
    _check_impl(impl)
    if impl == "plain":
        return decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
    return flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=window)
