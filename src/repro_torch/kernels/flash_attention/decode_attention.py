"""Ragged flash-decoding: CUDA kernel wrappers and their plain versions.

Port of ``repro/kernels/flash_attention/decode_attention.py``.  One query
token per (row, kv head) attends over a ragged prefix of the row's KV:

  * :func:`flash_decode_cuda` / :func:`decode_attention_plain` — the
    contiguous cache ``(B, S, KV, d)``, KV split ``bk``;
  * :func:`flash_decode_paged_cuda` / :func:`decode_attention_paged_plain`
    — a shared block pool ``(num_blocks, bs, KV, d)`` read through per-row
    block tables ``(B, n_blk)``; one split is one physical block.

The CUDA kernels (``kernels/csrc/decode_attention.cu``) share one body, so
paged equals contiguous bitwise at ``bk == block_size`` on the card.  The
plain versions are the reference's jnp twins (``decode_attention_xla``,
``decode_attention_paged_xla``): the same blocked online-softmax recurrence
vectorized over rows, looping to the batch's deepest live split; a fully
masked split contributes exactly zero, so padding rows to the batch max
changes no bits.  They too are bitwise equal to each other at
``bk == block_size``.

Masking contract: row b's live keys are indices ``[0, lengths[b])`` with
lengths clamped to ``[1, S]`` (length 0 attends one key); masks use
``NEG_INF = -1e30``; ``p`` is rounded to V's dtype before the P.V product.

Each wrapper runs the plain version only when its tensors lie on the CPU.
A CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "flash_decode": [_P] * 5 + [_I] * 6 + [_F, _P],
    "flash_decode_paged": [_P] * 6 + [_I] * 7 + [_F, _P],
}
HEAD_DIMS = (64, 128)
MAX_G = 8
MAX_BK = 256


# ------------------------------------------------------------ plain versions


def _online_softmax(q, n_live, tile, live, v_dtype):
    """The shared recurrence: ``tile(j)`` gives split j's (kb, vb) as
    ``(B, bk, KV, d)`` and ``live(j)`` its ``(B, bk)`` key mask."""
    B, KV, G, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, d), dtype=torch.float32, device=q.device)
    for j in range(n_live):
        kb, vb = tile(j)
        s = torch.einsum("bhgd,bshd->bhgs", qf, kb.float()) * scale
        s = torch.where(live(j)[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgs,bshd->bhgd", p.to(v_dtype).float(), vb.float()
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor,        # (B, KV, G, d)
    k: torch.Tensor,        # (B, S, KV, d)
    v: torch.Tensor,        # (B, S, KV, d)
    lengths: torch.Tensor,  # (B,) int32
    *,
    bk: int = 128,
) -> torch.Tensor:
    """Plain version of :func:`flash_decode_cuda` (the reference's
    ``decode_attention_xla``)."""
    S = k.shape[1]
    if S % bk:
        raise ValueError(f"cache extent {S} is not a multiple of bk={bk}")
    lengths = torch.clamp(lengths.to(torch.int32), 1, S)
    n_live = int(((lengths + bk - 1) // bk).max())
    ar = torch.arange(bk, dtype=torch.int32, device=q.device)
    return _online_softmax(
        q, n_live,
        lambda j: (k[:, j * bk : (j + 1) * bk], v[:, j * bk : (j + 1) * bk]),
        lambda j: (j * bk + ar)[None, :] < lengths[:, None],
        v.dtype,
    )


def _paged_live(k_idx, length, window):
    """Logical index < length, plus an optional sliding window against the
    query position ``length - 1`` (logical index == position)."""
    ok = k_idx < length
    if window is not None:
        ok &= k_idx > length - 1 - window
    return ok


def decode_attention_paged_plain(
    q: torch.Tensor,        # (B, KV, G, d)
    kpool: torch.Tensor,    # (num_blocks, bs, KV, d)
    vpool: torch.Tensor,    # (num_blocks, bs, KV, d)
    tables: torch.Tensor,   # (B, n_blk) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged_cuda` (the reference's
    ``decode_attention_paged_xla``): each split's block is gathered through
    the table."""
    bs = kpool.shape[1]
    lengths = torch.clamp(lengths.to(torch.int32), 1, tables.shape[1] * bs)
    tables = tables.long()
    n_live = int(((lengths + bs - 1) // bs).max())
    ar = torch.arange(bs, dtype=torch.int32, device=q.device)
    return _online_softmax(
        q, n_live,
        lambda j: (kpool[tables[:, j]], vpool[tables[:, j]]),
        lambda j: _paged_live((j * bs + ar)[None, :], lengths[:, None], window),
        vpool.dtype,
    )


# ------------------------------------------------------------ CUDA wrappers


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(q: torch.Tensor, pairs: dict) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode attention needs CPU or CUDA tensors, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, not the current CUDA device")
    B, KV, G, d = q.shape
    if d not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS} and G <= {MAX_G}: {q.shape}")
    for name, (t, dtype) in pairs.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")


def flash_decode_cuda(
    q: torch.Tensor,        # (B, KV, G, d) bf16
    k: torch.Tensor,        # (B, S, KV, d) bf16
    v: torch.Tensor,        # (B, S, KV, d) bf16
    lengths: torch.Tensor,  # (B,) int32
    *,
    bk: int = 128,
) -> torch.Tensor:
    """Contiguous ragged decode attention on the card; replaces the TPU
    kernel ``flash_decode_pallas``.  CPU tensors take the plain version."""
    if _on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, bk=bk)
    bf = torch.bfloat16
    _check_cuda(q, {"q": (q, bf), "k": (k, bf), "v": (v, bf), "lengths": (lengths, torch.int32)})
    B, KV, G, d = q.shape
    S = k.shape[1]
    if k.shape != (B, S, KV, d) or v.shape != k.shape or lengths.shape != (B,):
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape} lengths {lengths.shape}")
    if not 1 <= bk <= MAX_BK or S % bk:
        raise ValueError(f"bk={bk} must divide S={S} and be <= {MAX_BK}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.library("decode_attention", _SIGS)
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, S, KV, G, d, bk, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "flash_decode")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode_paged_cuda(
    q: torch.Tensor,        # (B, KV, G, d) bf16
    kpool: torch.Tensor,    # (num_blocks, bs, KV, d) bf16
    vpool: torch.Tensor,    # (num_blocks, bs, KV, d) bf16
    tables: torch.Tensor,   # (B, n_blk) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Paged ragged decode attention on the card; replaces the TPU kernel
    ``flash_decode_paged_pallas``.  CPU tensors take the plain version."""
    if _on_cpu(q, kpool, vpool, tables, lengths):
        return decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
    bf, i32 = torch.bfloat16, torch.int32
    _check_cuda(q, {
        "q": (q, bf), "kpool": (kpool, bf), "vpool": (vpool, bf),
        "tables": (tables, i32), "lengths": (lengths, i32),
    })
    B, KV, G, d = q.shape
    nb, bs = kpool.shape[:2]
    n_blk = tables.shape[1] if tables.ndim == 2 else -1
    if (kpool.shape != (nb, bs, KV, d) or vpool.shape != kpool.shape
            or tables.shape != (B, n_blk) or lengths.shape != (B,)):
        raise ValueError(
            f"shapes q {q.shape} pools {kpool.shape}/{vpool.shape} "
            f"tables {tables.shape} lengths {lengths.shape}"
        )
    if not 1 <= bs <= MAX_BK:
        raise ValueError(f"block size {bs} must be <= {MAX_BK}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.library("decode_attention", _SIGS)
    err = lib.flash_decode_paged(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        B, n_blk, bs, KV, G, d, -1 if window is None else window,
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "flash_decode_paged")
    flash_decode_paged_cuda.launches += 1
    return out


flash_decode_paged_cuda.launches = 0
