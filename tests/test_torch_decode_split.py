"""The split decomposition of the port's decode-attention kernel, on the CPU.

``csrc/decode_attention.cu`` splits each (row, kv head)'s KV across the
blocks of a cluster and still reproduces the plain online-softmax
recurrence (``decode_attention_plain`` / ``decode_attention_paged_plain``)
bit for bit.  The kernel cannot run here, so :func:`split_model` models its
phases in plain torch, with the kernel's block partition and exchange:

1. every split's scores ``fp32(sum64 q.k) * scale`` (masked to -1e30) and
   each block's maximum over its splits;
2. the prefix max ``m_j`` from the lower ranks' maxima and the block's own
   running max; per split ``p``, ``corr_j``, ``sum_j`` and ``pv_j`` from
   ``m_j`` and ``m_{j-1}`` alone;
3. the ordered fp32 replay ``l = l*corr_j + sum_j``, ``acc = acc*corr_j +
   pv_j`` over the row's live splits, ``out = acc / max(l, 1e-30)``.

The model must equal the plain versions bitwise in bf16 and fp32: both
compute each split's score and P.V products with the same einsums, so
what is tested is the decomposition, not the order of a sum.  Leading
splits that the paged window masks entirely are skipped, as the kernel
skips them; a second case shows that walking them changes no bit.  The
launch plan (:func:`plan`) is checked here too: the grid fills the card
at recurrentgemma-2b's shape, and it takes every shape the kernel took
before it was split.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import hw
from repro_torch.kernels.flash_attention import decode_attention as dec

NEG_INF = dec.NEG_INF


def _split_partition(j0: int, n_live: int, cluster: int) -> list[tuple[int, int]]:
    """Block r's splits [jb, je): the kernel's even cut of the live range."""
    nl = n_live - j0
    return [(j0 + r * nl // cluster, j0 + (r + 1) * nl // cluster) for r in range(cluster)]


def split_model(q, n_splits, tile, live, lengths, max_len, bk, window, v_dtype,
                cluster, skip_leading=True):
    """The kernel's phases in plain torch; ``tile(j)`` gives split j's
    (kb, vb) as ``(B, bk, KV, d)`` and ``live(j)`` its ``(B, bk)`` mask."""
    B, KV, G, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qd = q.double()
    lens = [min(max(int(x), 1), max_len) for x in lengths]
    ranges = []
    for ln in lens:
        n_live = -(-ln // bk)
        j0 = max(0, ln - window) // bk if (skip_leading and window and window > 0) else 0
        ranges.append((j0, n_live))
    # phase 1: scores of every split, and each block's maximum
    s = []
    for j in range(n_splits):
        kb, _ = tile(j)
        sj = torch.einsum("bhgd,bshd->bhgs", qd, kb.double()).float() * scale
        s.append(torch.where(live(j)[:, None, None, :], sj, torch.full_like(sj, NEG_INF)))
    neg = torch.full((KV, G), NEG_INF)
    m = [[None] * n_splits for _ in range(B)]  # m[b][j]: (KV, G) prefix max
    m_prev = [[None] * n_splits for _ in range(B)]
    for b, (j0, n_live) in enumerate(ranges):
        blocks = _split_partition(j0, n_live, cluster)
        bmax = []
        for jb, je in blocks:
            mx = neg.clone()
            for j in range(jb, je):
                mx = torch.maximum(mx, s[j][b].amax(dim=-1))
            bmax.append(mx)
        # phase 2: the lower ranks' maxima, then the block's own running max
        for r, (jb, je) in enumerate(blocks):
            run = neg.clone()
            for lower in bmax[:r]:
                run = torch.maximum(run, lower)
            for j in range(jb, je):
                m_prev[b][j] = run
                run = torch.maximum(run, s[j][b].amax(dim=-1))
                m[b][j] = run
    # the split partials, computed for every row at once (rows outside a
    # split's walk get a placeholder max and are never replayed)
    parts = []
    for j in range(n_splits):
        mj = torch.stack([m[b][j] if m[b][j] is not None else neg for b in range(B)])
        mp = torch.stack([m_prev[b][j] if m_prev[b][j] is not None else neg for b in range(B)])
        p = torch.exp((s[j] - mj[..., None]).double()).float()
        corr = torch.exp((mp - mj).double()).float()
        sums = p.double().sum(dim=-1).float()
        _, vb = tile(j)
        pv = torch.einsum("bhgs,bshd->bhgd", p.to(v_dtype).double(), vb.double()).float()
        parts.append((corr, sums, pv))
    # phase 3: the ordered fp32 replay over each row's walked splits
    l = torch.zeros((B, KV, G))
    acc = torch.zeros((B, KV, G, d))
    for j in range(n_splits):
        on = torch.tensor([j0 <= j < n_live for j0, n_live in ranges])
        corr, sums, pv = parts[j]
        l = torch.where(on[:, None, None], l * corr + sums, l)
        acc = torch.where(on[:, None, None, None], acc * corr[..., None] + pv, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _tensor(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _contiguous_case(B, S, KV, G, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_tensor(rng.standard_normal(sh, np.float32), dtype)
               for sh in ((B, KV, G, d), (B, S, KV, d), (B, S, KV, d)))
    return q, k, v


def _contiguous_model(q, k, v, lengths, bk, cluster):
    S = k.shape[1]
    ln = torch.clamp(lengths, 1, S)
    ar = torch.arange(bk, dtype=torch.int32)
    return split_model(
        q, S // bk, lambda j: (k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk]),
        lambda j: (j * bk + ar)[None, :] < ln[:, None], lengths.tolist(), S, bk, None,
        v.dtype, cluster)


def _lengths(S, bk, B, rng):
    """Ragged lengths with 0, 1, exact multiples of bk and S among them."""
    fixed = [0, 1, bk, S, 2 * bk if 2 * bk <= S else S - 1]
    rest = rng.integers(1, S + 1, size=max(0, B - len(fixed))).tolist()
    return torch.tensor((fixed + rest)[:B], dtype=torch.int32)


CONTIGUOUS = [
    # (B, S, KV, G, d, bk, cluster): split counts 1 to 32, clusters that do
    # not divide them, G 1-16, d 16-256
    (5, 16, 1, 1, 16, 16, 8),
    (6, 64, 2, 3, 64, 16, 8),
    (8, 256, 1, 10, 256, 64, 8),
    (5, 96, 2, 16, 32, 8, 5),
    (6, 128, 1, 2, 240, 32, 3),
    (5, 120, 2, 7, 40, 24, 8),
    (7, 72, 1, 4, 128, 8, 7),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,KV,G,d,bk,cluster", CONTIGUOUS)
def test_split_model_equals_contiguous_plain_bitwise(B, S, KV, G, d, bk, cluster, dtype):
    q, k, v = _contiguous_case(B, S, KV, G, d, dtype, seed=G * d + S)
    lengths = _lengths(S, bk, B, np.random.default_rng(bk))
    want = dec.decode_attention_plain(q, k, v, lengths, bk=bk)
    got = _contiguous_model(q, k, v, lengths, bk, cluster)
    assert got.dtype == dtype and torch.equal(got, want)
    # the cluster size never shows in the output
    assert torch.equal(_contiguous_model(q, k, v, lengths, bk, 1), want)


def _paged_case(B, n_blk, bs, KV, G, d, dtype, seed):
    """A pool in which rows share physical blocks (a common prefix) and
    the tables alias them, as prefix sharing does."""
    rng = np.random.default_rng(seed)
    nb = B * n_blk + 1
    q = _tensor(rng.standard_normal((B, KV, G, d), np.float32), dtype)
    kpool, vpool = (_tensor(rng.standard_normal((nb, bs, KV, d), np.float32), dtype)
                    for _ in "kv")
    tables = (rng.permutation(B * n_blk) + 1).reshape(B, n_blk)
    shared = rng.integers(1, max(2, n_blk // 2))
    tables[1:, :shared] = tables[0, :shared]  # every row aliases row 0's prefix
    return q, kpool, vpool, torch.from_numpy(tables.astype(np.int32))


def _paged_model(q, kpool, vpool, tables, lengths, window, cluster, skip_leading=True):
    bs, n_blk = kpool.shape[1], tables.shape[1]
    ln = torch.clamp(lengths, 1, n_blk * bs)
    ar = torch.arange(bs, dtype=torch.int32)
    tl = tables.long()
    return split_model(
        q, n_blk, lambda j: (kpool[tl[:, j]], vpool[tl[:, j]]),
        lambda j: dec._paged_live((j * bs + ar)[None, :], ln[:, None], window),
        lengths.tolist(), n_blk * bs, bs, window, vpool.dtype, cluster, skip_leading)


PAGED = [
    # (B, n_blk, bs, KV, G, d, cluster, window): windows that mask whole
    # leading splits, one that masks none
    (6, 9, 16, 2, 3, 64, 8, 20),
    (5, 7, 8, 1, 10, 256, 8, 9),
    (6, 33, 4, 1, 16, 16, 8, 50),
    (4, 12, 16, 2, 2, 240, 5, 1),
    (5, 8, 16, 1, 5, 48, 3, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,n_blk,bs,KV,G,d,cluster,window", PAGED)
def test_split_model_equals_paged_plain_bitwise(B, n_blk, bs, KV, G, d, cluster, window,
                                                dtype):
    q, kpool, vpool, tables = _paged_case(B, n_blk, bs, KV, G, d, dtype, seed=G + d + n_blk)
    lengths = _lengths(n_blk * bs, bs, B, np.random.default_rng(n_blk))
    want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
    got = _paged_model(q, kpool, vpool, tables, lengths, window, cluster)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [1, 5, 17, 40])
def test_skipping_fully_masked_leading_splits_changes_no_bit(window, dtype):
    """Under a paged window the splits before the first live key score
    -1e30 everywhere: walked, they give p = 1 against a prefix max of
    -1e30, and the first live split's corr = exp(-1e30 - m) = 0 wipes
    them.  The kernel skips them; walking them gives the same bits."""
    B, n_blk, bs, KV, G, d = 6, 10, 8, 2, 4, 32
    q, kpool, vpool, tables = _paged_case(B, n_blk, bs, KV, G, d, dtype, seed=window)
    lengths = torch.tensor([80, 79, 41, 64, 9, 50], dtype=torch.int32)
    skipped = [max(0, int(x) - window) // bs for x in lengths]
    assert max(skipped) >= 2  # whole leading splits are masked
    walked = _paged_model(q, kpool, vpool, tables, lengths, window, 8, skip_leading=False)
    skipping = _paged_model(q, kpool, vpool, tables, lengths, window, 8)
    want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
    assert torch.equal(skipping, walked) and torch.equal(skipping, want)


def test_rows_alone_equal_rows_in_the_batch():
    """Nothing in the decomposition depends on the other rows."""
    q, k, v = _contiguous_case(6, 64, 2, 3, 64, torch.bfloat16, seed=3)
    lengths = torch.tensor([3, 64, 17, 1, 48, 33], dtype=torch.int32)
    batch = _contiguous_model(q, k, v, lengths, 16, 8)
    for b in range(6):
        solo = _contiguous_model(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1], 16, 8)
        assert torch.equal(solo[0], batch[b])


# ------------------------------------------------------------ launch plan


def test_plan_fills_the_card_at_recurrentgemma_shape():
    """recurrentgemma-2b's decode: 8 rows, one KV head of 10 query heads at
    head_dim 256, a 2048-slot ring cut in splits of 64.  One block per
    (row, kv head) gave 8 blocks; the cluster gives 64."""
    p = dec.plan(8, 1, 10, 256, 64, 2048 // 64, 2)
    assert p.grid(8, 1) >= 64 and p.cluster == 8 and p.nbuf >= 2
    # smollm-360m's decode (8 rows, 5 KV heads, 16-key blocks of 1024
    # slots): 320 blocks, resident at once (3 a SM), tiles of 4 splits
    p = dec.plan(8, 5, 3, 64, 16, 64, 2)
    smem = dec.smem_bytes(3, 64, 16, 2, p.ts, p.nbuf)
    assert p.cluster == 8 and p.grid(8, 5) <= dec.blocks_per_sm(smem) * hw.SM_COUNT
    assert p.ts == 4 and p.nbuf >= 2
    # about 2.6 MB of partials plus the score rows, which stays in L2
    ws = dec.workspace_floats(8, 1, 10, 256, 64, 32) * 4
    assert 2.6e6 < ws < 3.4e6


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_takes_every_shape_the_unsplit_kernel_took(itemsize):
    """The kernel before the split asked for (3*16 + 2*G*d + G*bk) fp32
    words and its K and V tiles (K rows padded by 16 bytes); every shape
    that fit in 227 KB then still fits, with one ring stage if two do not."""
    for G in (1, 2, 3, 7, 8, 9, 10, 16):
        for d in range(8, 257, 8):
            for bk in (1, 3, 5, 8, 16, 24, 32, 33, 64, 100, 128, 200, 256):
                old = (3 * 16 + 2 * G * d + G * bk) * 4 + bk * (2 * d * itemsize + 16)
                p = dec.plan(8, 1, G, d, bk, 4, itemsize)
                new = dec.smem_bytes(G, d, bk, itemsize, p.ts, p.nbuf)
                if old <= hw.SMEM_PER_BLOCK_BYTES:
                    assert new <= hw.SMEM_PER_BLOCK_BYTES, (G, d, bk, old, new)


def test_plan_cluster_never_exceeds_the_splits_or_eight():
    """Up to 8 blocks per (row, kv head), never more than the splits, and
    the grid resident in one wave while it can be; at least two ring
    stages where they fit."""
    for G, d, bk, itemsize in ((10, 256, 64, 2), (3, 64, 16, 2), (2, 240, 64, 2),
                               (16, 256, 128, 4)):
        for B, KV in ((1, 1), (8, 1), (8, 5), (8, 8), (64, 8)):
            for n in (1, 2, 7, 9, 33, 256):
                p = dec.plan(B, KV, G, d, bk, n, itemsize)
                smem = dec.smem_bytes(G, d, bk, itemsize, p.ts, p.nbuf)
                assert smem <= hw.SMEM_PER_BLOCK_BYTES and 1 <= p.cluster <= min(8, n)
                assert p.cluster == 1 or p.grid(B, KV) <= dec.blocks_per_sm(smem) * hw.SM_COUNT
                two = dec.smem_bytes(G, d, bk, itemsize, p.ts, 2) <= hw.SMEM_PER_BLOCK_BYTES
                assert p.nbuf >= 2 or not two
