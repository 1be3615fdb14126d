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
KV of each (row, kv head) is split across the blocks of one thread-block
cluster (:func:`plan`); the splits run in parallel and an ordered fp32
replay of their partials reproduces the plain recurrence bit for bit.
One launch per call; the wrapper allocates the kernel's fp32 workspace
and never reads ``lengths`` back to the host.  The plain versions are the
reference's jnp twins (``decode_attention_xla``,
``decode_attention_paged_xla``): the same blocked online-softmax recurrence
vectorized over rows, looping to the batch's deepest live split; a fully
masked split contributes exactly zero, so padding rows to the batch max
changes no bits.  They too are bitwise equal to each other at
``bk == block_size``.

Masking contract: row b's live keys are indices ``[0, lengths[b])`` with
lengths clamped to ``[1, S]`` (length 0 attends one key); masks use
``NEG_INF = -1e30``; ``p`` is rounded to V's dtype before the P.V product.

The kernels take q, K and V all bf16 or all fp32, every head_dim that is
a multiple of 8 up to 256 and groups of up to 16 query heads.  In bf16,
kernel and plain version are bitwise equal on the card, which the ABFT
attention fingerprint (``kernels/abft.py``) relies on.  Their reduction
orders cannot match, so neither depends on one: the q.k and p.V dot
products and each split's sum of p accumulate in fp64, where products of
bf16 values add exactly, and round once to fp32; exp runs in fp64 and
rounds once; every other step is one round-to-nearest fp32 operation.  In
fp32 the fp64 sums of fp32 products are not exact, so the two round sums
taken in other orders: they agree within :data:`FP32_TOL` of the output's
scale, inside the 1e-5 the fingerprint allows.

Each wrapper runs the plain version only when its tensors lie on the CPU.
A CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch import hw
from repro_torch.kernels import _build

NEG_INF = -1e30

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGS = {
    "flash_decode": [_P] * 6 + [_L, _P] + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "flash_decode_paged": [_P] * 7 + [_L, _P] + [_I] * 8 + [_F] + [_I] * 3 + [_P],
}
MAX_HEAD_DIM = 256  # head_dim: a multiple of 8 up to this
MAX_G = 16
MAX_BK = 256
DTYPES = (torch.bfloat16, torch.float32)
# kernel vs plain version in fp32, of the output's largest magnitude: fp64
# sums of fp32 products in two orders, each rounded once to fp32
FP32_TOL = 1e-6
THREADS = 256      # threads of one block
MAX_CLUSTER = 8    # blocks per (row, kv head): the portable cluster size
TILE_KEYS = 64     # a tile holds whole splits, at least this many keys
KERNELS_PER_CALL = 1
# Each block's device clock (ns) at entry, after phase 1 (scores), the
# first cluster barrier, phase 2 (split partials), the second barrier and
# exit.  Set PHASE_STAMPS to an int64 CUDA tensor of grid * STAMPS_PER_BLOCK
# entries and the next launches write them there (chip_smoke.py times the
# phases so); None, the default, records nothing.
STAMPS_PER_BLOCK = 6
PHASE_STAMPS: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel cuts one call: ``ts`` splits per K/V tile, ``nbuf``
    cp.async ring stages (1-4) and ``cluster`` blocks per (row, kv head).
    None of it changes a bit of the output: it decides only which block and
    which tile take a split, and every sum's order is fixed by d and bk."""

    ts: int
    nbuf: int
    cluster: int

    def grid(self, B: int, KV: int) -> int:
        return B * KV * self.cluster


def _bank_stride(nbytes: int, mod: int) -> int:
    """``bank_stride`` in the kernel: the least stride >= nbytes that is
    ``mod`` bytes past a multiple of 128."""
    return -(-(nbytes - mod) // 128) * 128 + mod


def smem_bytes(G: int, d: int, bk: int, itemsize: int, ts: int, nbuf: int) -> int:
    """Dynamic shared memory one block asks for (``Layout`` in
    ``csrc/decode_attention.cu``): ``nbuf`` stages of a K/V tile and its
    score rows; q and the tile's p in fp64, in rows of 8 heads; the tile's
    split and prefix maxima; the per-warp and per-block maxima of 16
    heads."""
    bkp = -(-bk // 4) * 4
    mt8 = -(-G // 8) * 8
    stage = ts * bk * _bank_stride(d * itemsize, 16) + ts * G * bkp * 4
    split = -(-(3 * ts * G * 4) // 16) * 16
    return (nbuf * stage + mt8 * _bank_stride(d * 8, 32) + ts * mt8 * _bank_stride(bkp * 8, 32)
            + split + (THREADS // 32 + 2) * MAX_G * 4)


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel one SM holds: at most 3 by registers
    (``__launch_bounds__(256, 3)``), and by shared memory (each block also
    costs the system's 1 KB)."""
    return min(3, hw.SMEM_PER_SM_BYTES // (smem + hw.SMEM_RESERVED_PER_BLOCK_BYTES))


def plan(B: int, KV: int, G: int, d: int, bk: int, n_splits: int, itemsize: int) -> Plan:
    """The launch plan for B rows of KV heads, G query heads of head_dim d,
    splits of bk keys and ``n_splits`` splits per row: short splits grouped
    into tiles of at least 64 keys (eight warps of 8-key mma columns); as
    many blocks per (row, kv head), up to 8, as keep the grid resident at
    once (a second wave would wait for the first); then the deepest ring
    (2 to 4 stages; 1 only where 2 do not fit) that keeps that cluster
    size."""
    ts = max(1, TILE_KEYS // bk)
    fits = [nb for nb in (2, 3, 4)
            if smem_bytes(G, d, bk, itemsize, ts, nb) <= hw.SMEM_PER_BLOCK_BYTES] or [1]
    best = None
    for nbuf in fits:
        resident = max(1, blocks_per_sm(smem_bytes(G, d, bk, itemsize, ts, nbuf))) * hw.SM_COUNT
        cluster = max(1, min(MAX_CLUSTER, n_splits, resident // max(1, B * KV)))
        if best is None or cluster >= best.cluster:
            best = Plan(ts, nbuf, cluster)
    return best


def workspace_floats(B: int, KV: int, G: int, d: int, bk: int, n_splits: int) -> int:
    """fp32 words of the kernel's workspace: per (row, kv head, split) the
    G score rows (padded to 4 words) and the partials corr, sum (G each)
    and pv (G * d)."""
    return B * KV * n_splits * G * (-(-bk // 4) * 4 + d + 2)


# ------------------------------------------------------------ plain versions


def _online_softmax(q, n_live, tile, live, v_dtype):
    """The shared recurrence: ``tile(j)`` gives split j's (kb, vb) as
    ``(B, bk, KV, d)`` and ``live(j)`` its ``(B, bk)`` key mask."""
    B, KV, G, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qd = q.double()
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, d), dtype=torch.float32, device=q.device)
    for j in range(n_live):
        kb, vb = tile(j)
        s = torch.einsum("bhgd,bshd->bhgs", qd, kb.double()).float() * scale
        s = torch.where(live(j)[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp((s - m_new[..., None]).double()).float()
        corr = torch.exp((m - m_new).double()).float()
        l = l * corr + p.double().sum(dim=-1).float()
        acc = acc * corr[..., None] + torch.einsum(
            "bhgs,bshd->bhgd", p.to(v_dtype).double(), vb.double()
        ).float()
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
    n_live: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged_cuda` (the reference's
    ``decode_attention_paged_xla``): each split's block is gathered through
    the table.  ``n_live`` bounds the splits walked; None reads the
    deepest row's split count back from the tensors.  A bound above it
    changes no bits (a fully masked split adds exactly nothing)."""
    bs = kpool.shape[1]
    lengths = torch.clamp(lengths.to(torch.int32), 1, tables.shape[1] * bs)
    tables = tables.long()
    if n_live is None:
        n_live = int(((lengths + bs - 1) // bs).max())
    n_live = min(n_live, tables.shape[1])
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


def _check_cuda(q: torch.Tensor, pairs: dict, bk: int, n_splits: int) -> Plan:
    """Raise on what the kernel does not take, else return the launch
    plan; ``pairs`` maps each operand's name to (tensor, dtype), None
    standing for q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention needs CPU or CUDA tensors, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, not the current CUDA device")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KV, G, d): {tuple(q.shape)}")
    B, KV, G, d = q.shape
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM or not 1 <= G <= MAX_G:
        raise ValueError(f"kernel takes head_dim a multiple of 8 up to {MAX_HEAD_DIM} "
                         f"and G <= {MAX_G}: {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"kernel takes bf16 or fp32 q, K and V, got {q.dtype}")
    for name, (t, dtype) in pairs.items():
        dtype = dtype or q.dtype
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} (q's type for K and V), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dtype in DTYPES and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    p = plan(B, KV, G, d, bk, n_splits, q.element_size())
    smem = smem_bytes(G, d, bk, q.element_size(), p.ts, p.nbuf)
    if smem > hw.SMEM_PER_BLOCK_BYTES:
        raise ValueError(f"G={G}, head_dim={d}, split {bk} in {q.dtype} need {smem} B of "
                         f"shared memory, past the {hw.SMEM_PER_BLOCK_BYTES} B a block may have")
    return p


def _stamps_ptr() -> int | None:
    return None if PHASE_STAMPS is None else PHASE_STAMPS.data_ptr()


def flash_decode_cuda(
    q: torch.Tensor,        # (B, KV, G, d) bf16 or fp32
    k: torch.Tensor,        # (B, S, KV, d) q's dtype
    v: torch.Tensor,        # (B, S, KV, d) q's dtype
    lengths: torch.Tensor,  # (B,) int32
    *,
    bk: int = 128,
) -> torch.Tensor:
    """Contiguous ragged decode attention on the card; replaces the TPU
    kernel ``flash_decode_pallas``.  CPU tensors take the plain version."""
    if _on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, bk=bk)
    B, KV, G, d = q.shape
    S = k.shape[1]
    if k.shape != (B, S, KV, d) or v.shape != k.shape or lengths.shape != (B,):
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape} lengths {lengths.shape}")
    if not 1 <= bk <= MAX_BK or S % bk:
        raise ValueError(f"bk={bk} must divide S={S} and be <= {MAX_BK}")
    p = _check_cuda(q, {"q": (q, None), "k": (k, None), "v": (v, None),
                        "lengths": (lengths, torch.int32)}, bk, S // bk)
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_ws = workspace_floats(B, KV, G, d, bk, S // bk)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attention", _SIGS)
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n_ws, _stamps_ptr(), B, S, KV, G, d, bk, int(q.dtype == torch.float32),
        1.0 / math.sqrt(d), p.ts, p.nbuf, p.cluster,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "flash_decode")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode_paged_cuda(
    q: torch.Tensor,        # (B, KV, G, d) bf16 or fp32
    kpool: torch.Tensor,    # (num_blocks, bs, KV, d) q's dtype
    vpool: torch.Tensor,    # (num_blocks, bs, KV, d) q's dtype
    tables: torch.Tensor,   # (B, n_blk) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Paged ragged decode attention on the card; replaces the TPU kernel
    ``flash_decode_paged_pallas``.  CPU tensors take the plain version."""
    if _on_cpu(q, kpool, vpool, tables, lengths):
        return decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
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
    i32 = torch.int32
    p = _check_cuda(q, {
        "q": (q, None), "kpool": (kpool, None), "vpool": (vpool, None),
        "tables": (tables, i32), "lengths": (lengths, i32),
    }, bs, n_blk)
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_ws = workspace_floats(B, KV, G, d, bs, n_blk)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    lib = _build.library("decode_attention", _SIGS)
    err = lib.flash_decode_paged(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), n_ws, _stamps_ptr(),
        B, n_blk, bs, KV, G, d, -1 if window is None else window,
        int(q.dtype == torch.float32), 1.0 / math.sqrt(d), p.ts, p.nbuf, p.cluster,
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "flash_decode_paged")
    flash_decode_paged_cuda.launches += 1
    return out


flash_decode_paged_cuda.launches = 0
