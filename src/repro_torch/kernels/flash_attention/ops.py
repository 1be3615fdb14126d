"""Attention entry points; port of ``repro/kernels/flash_attention/ops.py``.

:func:`flash_attention` is the prefill/chunk entry point (l.100-134), and
:func:`decode_attention` / :func:`decode_attention_paged` the decode half
(l.137-240).  ``impl``: None runs the CUDA kernel wrapper (which takes the
plain version only for CPU tensors); "plain" runs the plain version on any
device, the oracle substrate of ``KernelConfig(attention="xla")`` engines.
The reference's G -> 8 query padding exists only for the TPU's sublanes and
is not ported; nor is its ``_pad_blocks``: the flash kernel masks its own
ragged edges and reproduces the padded keys' effect (``flash_attention``'s
module docstring).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.decode_attention import (
    decode_attention_paged_plain,
    decode_attention_plain,
    flash_decode_cuda,
    flash_decode_paged_cuda,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)


def _pick_decode_bk(S: int) -> int:
    """KV split for contiguous decode: the largest divisor of the cache
    extent S that is at most 64, so the cache is never padded and the
    ragged skip stays fine-grained.  This is the reference's rule for its
    jnp twin (``repro/kernels/flash_attention/ops.py:137-158``): there the
    search's KV tile is capped at 64 and floored at 8 before it steps down
    to a divisor, and a TPU-aligned tile is at least 128 wide, so the cap
    always wins.  (The Hopper tile search is ROADMAP A6c.)"""
    b = max(1, min(64, S))
    while S % b:
        b -= 1
    return b


def _check_impl(impl: str | None) -> None:
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None (kernel) or 'plain': {impl!r}")


def flash_attention(
    q: torch.Tensor,        # (B, Tq, KV, G, d) grouped-query layout
    k: torch.Tensor,        # (B, Tk, KV, d)
    v: torch.Tensor,        # (B, Tk, KV, d)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
    bq: int = 256,
    bk: int = 512,
    impl: str | None = None,
) -> torch.Tensor:
    """Returns (B, Tq, KV, G, d).  A call with ``q_offset == 0`` and no
    ``kv_len`` is the reference's static variant (every key block visited);
    any other is its dynamic one (``kv_len`` defaults to Tk and is clamped
    to it; blocks past it are skipped).  ``q_offset`` and ``kv_len`` are
    run-time arguments of the kernel, so no length builds anything.  ``bk``
    (capped at Tk) fixes which keys the reference visits, and so the output
    of a query with no live key.  ``bq`` is accepted for the reference's
    signature and has no effect: it splits only independent query rows."""
    _check_impl(impl)
    B, Tq, KV, G, d = q.shape
    Tk = k.shape[1]
    if bk < 1:
        raise ValueError(f"bk must be positive: {bk}")
    static = int(q_offset) == 0 and kv_len is None
    kv = None if static else min(Tk if kv_len is None else int(kv_len), Tk)
    fn = flash_attention_plain if impl == "plain" else flash_attention_cuda
    out = fn(
        q.reshape(B, Tq, KV * G, d).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        bk=min(bk, Tk), causal=causal, window=window, q_offset=int(q_offset), kv_len=kv,
    )
    return out.transpose(1, 2).reshape(B, Tq, KV, G, d)


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
    n_live: int | None = None,
) -> torch.Tensor:
    """Block-table-indirect ragged flash-decoding; returns (B, KV, G, d).
    The KV split is the pool's block size, so the logical reduction order
    matches the contiguous path at ``bk == block_size``.  ``n_live`` (plain
    version only) is a host-known upper bound on the rows' live splits."""
    _check_impl(impl)
    if impl == "plain":
        return decode_attention_paged_plain(
            q, kpool, vpool, tables, lengths, window=window, n_live=n_live
        )
    return flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=window)
