"""Attention compute paths; port of ``repro/arch/attention.py``.

  * dense          — einsum + softmax, for short sequences.
  * blockwise      — online-softmax tiles over (q-block, kv-block), the
                     portable flash-attention recurrence.
  * flash-decoding — cached single-token decode over a ragged KV prefix
                     (``kernels/flash_attention``), dispatched by
                     :func:`attend` when the caller passes per-slot
                     ``decode_lengths`` and ``decode_impl="flash"``.

Prefill attention is plain torch einsum/softmax, as the reference's is
plain jnp outside Pallas.  Given ``q_block``, :func:`attend` runs it in
fixed-shape pieces (:func:`attend_pieces`), so a row's bits do not depend
on how many rows or queries the call holds.  All paths take grouped-query tensors
``q: (B, Tq, KV, G, hd)``, ``k/v: (B, Tk, KV, hd)`` and return
``(B, Tq, KV, G, hd)``.  Rounding follows the reference: a bf16 einsum
returns bf16 scores, which are then cast to fp32.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs

NEG_INF = -1e30
# pieces of (one row, q_block queries) that one call of attend_pieces
# computes together; short calls are filled up with copies of a piece
PIECES_PER_CALL = 8


def _bias_block(
    q_pos: torch.Tensor,   # (bq,) or (B, bq) for per-slot decode caches
    k_pos: torch.Tensor,   # (bk,) or (B, bk)
    causal: bool,
    window: int | None,
    kv_len: torch.Tensor | None,
) -> torch.Tensor:
    """Additive fp32 mask, broadcasting over a leading batch dim when
    either position vector is per-batch."""
    qp = q_pos.to(torch.int32)
    kp = k_pos.to(torch.int32)
    diff = qp[..., :, None] - kp[..., None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    if kv_len is not None:
        ok &= kp[..., None, :] < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _add_bias(scores: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """scores: (B, KV, G, Tq, Tk); bias: (Tq, Tk) or (B, Tq, Tk)."""
    if bias.ndim == 2:
        return scores + bias
    return scores + bias[:, None, None]


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    scores = _add_bias(scores, _bias_block(q_pos, k_pos, causal, window, kv_len))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    kv_len: torch.Tensor | None = None,
    block_q: int = 512,
    block_k: int = 1024,
    causal_skip: bool = False,
) -> torch.Tensor:
    """Online-softmax tiled attention; O(block_q*block_k) live scores.

    ``causal_skip`` truncates each q block's kv loop at the causal frontier;
    it requires aligned positions (q_pos == k_pos == arange)."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    pq, pk = (-Tq) % bq, (-Tk) % bk
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = torch.cat([q_pos, q_pos[..., -1:].expand(*q_pos.shape[:-1], pq)], -1)
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        pad = torch.full(
            k_pos.shape[:-1] + (pk,), -(10**9), dtype=k_pos.dtype, device=k_pos.device
        )
        k_pos = torch.cat([k_pos, pad], -1)
    nq, nk = q.shape[1] // bq, k.shape[1] // bk

    outs = []
    for i in range(nq):
        qi = q[:, i * bq : (i + 1) * bq]
        qp = q_pos[..., i * bq : (i + 1) * bq]
        hi = min(nk, ((i + 1) * bq + bk - 1) // bk) if causal_skip and causal else nk
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=q.device)
        for j in range(hi):
            ki = k[:, j * bk : (j + 1) * bk]
            vi = v[:, j * bk : (j + 1) * bk]
            kp = k_pos[..., j * bk : (j + 1) * bk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki).float()
            s = _add_bias(s * scale, _bias_block(qp, kp, causal, window, kv_len))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(qi.dtype), vi
            ).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(qi.dtype))  # (B, KV, G, bq, hd)
    ob = torch.stack(outs)  # (nq, B, KV, G, bq, hd)
    out = ob.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * bq, KV, G, hd)
    return out[:, :Tq]


def attend_pieces(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    window: int | None,
    q_block: int,
    dense_threshold: int,
) -> torch.Tensor:
    """Attention computed in pieces of one row's ``q_block`` queries (the
    last one padded with copies of its final query), ``PIECES_PER_CALL`` of
    them a call (the last call filled up with copies of a piece), so every
    product, softmax and mask runs at one shape whatever the caller's batch
    and query count: a row's result is the same bits in a batched
    admission, a lone re-prefill and a chunk of a longer prompt.  Each
    piece's arithmetic is the dense (or blockwise) path's."""
    B, Tq, KV, G, hd = q.shape
    Tk = k.shape[1]
    nb = -(-Tq // q_block)
    pad = nb * q_block - Tq
    qp = q_pos if q_pos.ndim == 2 else q_pos[None].expand(B, Tq)
    kp = k_pos if k_pos.ndim == 2 else k_pos[None].expand(B, Tk)
    if pad:
        q = torch.cat([q, q[:, -1:].expand(B, pad, KV, G, hd)], 1)
        qp = torch.cat([qp, qp[:, -1:].expand(B, pad)], 1)
    n = B * nb
    fill = (-n) % PIECES_PER_CALL
    pieces = q.reshape(n, q_block, KV, G, hd)
    piece_pos = qp.reshape(n, q_block)
    rows = torch.arange(B, device=q.device).repeat_interleave(nb)
    if fill:
        pieces = torch.cat([pieces, pieces[-1:].expand(fill, *pieces.shape[1:])])
        piece_pos = torch.cat([piece_pos, piece_pos[-1:].expand(fill, q_block)])
        rows = torch.cat([rows, rows[-1:].expand(fill)])
    path = dense_attention if q_block * Tk <= dense_threshold else blockwise_attention
    outs = []
    for c in range(0, n + fill, PIECES_PER_CALL):
        r = rows[c : c + PIECES_PER_CALL]
        outs.append(path(
            pieces[c : c + PIECES_PER_CALL], k[r], v[r],
            q_pos=piece_pos[c : c + PIECES_PER_CALL], k_pos=kp[r],
            causal=causal, window=window,
        ))
    out = torch.cat(outs)[:n].reshape(B, nb * q_block, KV, G, hd)
    return out[:, :Tq]


@obs.region("attention")
def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    kv_len: torch.Tensor | None = None,
    dense_threshold: int = 2048 * 2048,
    causal_skip: bool = False,
    decode_lengths: torch.Tensor | None = None,
    decode_impl: str | None = None,
    decode_block: int | None = None,
    q_block: int | None = None,
) -> torch.Tensor:
    """Dense vs blockwise by live-score size, or, for cached single-token
    decode with per-row ``decode_lengths`` and ``decode_impl="flash"``, the
    ragged decode kernel (``kernels.flash_attention.ops.decode_attention``).
    That kernel masks only by slot index < length, which equals the full
    causal + window + empty-slot mask under the serve ring invariant; the
    masked dense path stays its oracle.  With ``q_block`` (a prefill that
    must not depend on its call's shape) the pieces of
    :func:`attend_pieces`."""
    Tq, Tk = q.shape[1], k.shape[1]
    if decode_lengths is not None and decode_impl == "flash" and Tq == 1:
        from repro_torch.kernels.flash_attention.ops import decode_attention

        return decode_attention(q[:, 0], k, v, decode_lengths, bk=decode_block)[:, None]
    if q_block is not None:
        if kv_len is not None:
            raise ValueError("attend_pieces masks by position only (kv_len must be None)")
        return attend_pieces(
            q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
            q_block=q_block, dense_threshold=dense_threshold,
        )
    if Tq * Tk <= dense_threshold:
        return dense_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
            kv_len=kv_len,
        )
    return blockwise_attention(
        q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
        kv_len=kv_len, causal_skip=causal_skip,
    )
