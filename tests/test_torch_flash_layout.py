"""A numpy model of the bf16 flash-attention body (``csrc/flash_attention.cu``,
``flash_tc_kernel``) on the CPU.

The kernel cannot run here, so its index arithmetic and its walk are
rehearsed: the model follows the kernel's own formulas, with each hardware
unit reduced to what the kernel assumes of it:

- TMA writes a box of 64 columns x ``rows`` positions in row-major order,
  128 bytes a row, zeros outside the tensor, each 16-byte chunk moved by
  the 128-byte swizzle (byte bits 4-6 XORed with bits 7-9); a tile of d
  columns is ``ceil(d / 64)`` such panels, ``rows x 128`` bytes apart;
- a K-major operand descriptor (``hopper::desc_k128``, S = Q K^T: Q as A,
  K as B, imm-trans 0): element (row r, depth k) of a 16-deep step at
  ``start + (r // 8) * 1024 + (r % 8) * 128 + 2 k`` before the swizzle,
  the start moving 32 bytes a step inside the panel and a panel's bytes
  from one panel to the next;
- the N-major V descriptor (``hopper::desc_b128``, P V, imm-trans-b 1):
  element (key k, column n) at ``start + (n // 64) * LBO + (k // 8) * 1024
  + (k % 8) * 128 + 2 (n % 64)``, LBO a panel's bytes;
- the wgmma accumulator: thread T of warp w holds d[4 j + 2 i + e] = D[16 w
  + T / 4 + 8 i, 8 j + 2 (T % 4) + e]; the m16n8k16 A fragment of P: a[r]
  holds row g + 8 (r % 2), columns 8 (r // 2) + 2 (T % 4) + e.

Integer data makes every product exact, so the layout models must equal
the products bit for bit.  The walk (block order, ``tile_range`` at 128
queries, the test for tiles that need no mask, the log2-domain softmax)
is held to the plain version within the card's tolerance.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa

NEG_INF2 = np.float32(np.float32(-1e30) * np.float32(math.log2(math.e)))
LOG2E = np.float32(math.log2(math.e))


def swizzle(a):
    """``hopper::swizzle`` at the 128-byte span (mask 7)."""
    return a ^ (((a >> 7) & 7) << 4)


def tma_tile(rows2d, row0, rows, d):
    """``ceil(d / 64)`` TMA boxes of 64 columns x ``rows`` rows of a
    (n, d) array from row ``row0`` as shared memory (one int per bf16, by
    byte offset / 2): zeros past n and past d, swizzled, panels ``rows x
    128`` bytes apart."""
    dp = -(-d // 64)
    smem = np.zeros(dp * rows * 64, dtype=np.int64)
    n = rows2d.shape[0]
    for p in range(dp):
        for r in range(rows):
            for c in range(64):
                col = 64 * p + c
                val = rows2d[row0 + r, col] if row0 + r < n and col < d else 0
                smem[(p * rows * 128 + swizzle(r * 128 + 2 * c)) // 2] = val
    return smem


def read_k_major(smem, start, nrows):
    """The (nrows, 16) operand a K-major descriptor at byte ``start`` reads."""
    r = np.arange(nrows)[:, None]
    k = np.arange(16)[None, :]
    base = start - start % 1024
    off = start % 1024 + (r // 8) * 1024 + (r % 8) * 128 + 2 * k
    return smem[(base + swizzle(off)) // 2]


def read_n_major(smem, start, width, lbo):
    """The (16, width) B operand an N-major descriptor at ``start`` reads."""
    k = np.arange(16)[:, None]
    n = np.arange(width)[None, :]
    off = (n // 64) * lbo + (k // 8) * 1024 + (k % 8) * 128 + 2 * (n % 64)
    return smem[(start + swizzle(off)) // 2]


@pytest.mark.parametrize("d", [16, 40, 64, 128, 240, 256])
def test_tma_swizzle_places_each_key_and_depth(d):
    """Element (key r, depth c) of a K tile lies in panel c // 64, row r,
    16-byte chunk (c % 64) // 8 XOR r % 8; zeros fill the columns past d and
    the rows past the sequence's end."""
    bkv = fa.plan(d).bkv
    rng = np.random.default_rng(d)
    k = rng.integers(1, 100, (bkv - 5, d))  # the sequence ends inside the tile
    smem = tma_tile(k, 0, bkv, d)
    for r in range(bkv):
        for c in range(-(-d // 64) * 64):
            byte = (c // 64) * bkv * 128 + r * 128 + (((c % 64) // 8) ^ (r % 8)) * 16 + 2 * (c % 8)
            want = k[r, c] if r < k.shape[0] and c < d else 0
            assert smem[byte // 2] == want, (r, c)


@pytest.mark.parametrize("d", [16, 64, 136, 256])
@pytest.mark.parametrize("c", [0, 1])
def test_k_major_descriptors_compute_q_k_transposed(d, c):
    """Consumer c's S = Q K^T through the descriptors: A from the Q tile at
    ``c x 64 x 128`` bytes, B from the K tile, ``4 ceil(d / 64)`` steps of
    16 columns, each 32 bytes on inside a panel; equals the product."""
    pl = fa.plan(d)
    rng = np.random.default_rng(d + c)
    q = rng.integers(-3, 4, (pl.bq, d))
    k = rng.integers(-3, 4, (pl.bkv, d))
    qs, ks = tma_tile(q, 0, pl.bq, d), tma_tile(k, 0, pl.bkv, d)
    s = np.zeros((64, pl.bkv), dtype=np.int64)
    for kk in range(4 * -(-d // 64)):
        a = read_k_major(qs, (kk // 4) * pl.bq * 128 + c * 64 * 128 + 32 * (kk % 4), 64)
        b = read_k_major(ks, (kk // 4) * pl.bkv * 128 + 32 * (kk % 4), pl.bkv)
        s += a @ b.T
    np.testing.assert_array_equal(s, q[64 * c: 64 * c + 64] @ k.T)


def accumulator(d_mat):
    """Per thread of a warpgroup, the wgmma accumulator registers of a
    (64, n) matrix: regs[T][4 j + 2 i + e]."""
    n = d_mat.shape[1]
    regs = np.zeros((128, n // 2), dtype=d_mat.dtype)
    for t in range(128):
        w, lane = divmod(t, 32)
        for j in range(n // 8):
            for i in range(2):
                for e in range(2):
                    regs[t, 4 * j + 2 * i + e] = d_mat[16 * w + lane // 4 + 8 * i,
                                                       8 * j + 2 * (lane % 4) + e]
    return regs


@pytest.mark.parametrize("d", [16, 64, 192, 256])
def test_p_fragments_and_v_descriptor_compute_p_v(d):
    """P from the S registers (``pack_p``: pf[kc][r] = regs 8 kc + 2 r, + 1)
    read as each warp's m16n8k16 A fragments is S itself; with V through
    the N-major descriptor (a step 16 keys = 2048 bytes on) the products
    sum to P V."""
    pl = fa.plan(d)
    width = -(-d // 64) * 64
    rng = np.random.default_rng(d)
    p_mat = rng.integers(-3, 4, (64, pl.bkv))
    v = rng.integers(-3, 4, (pl.bkv, d))
    regs = accumulator(p_mat)
    vs = tma_tile(v, 0, pl.bkv, d)
    o = np.zeros((64, width), dtype=np.int64)
    for kc in range(pl.bkv // 16):
        frag = np.zeros((64, 16), dtype=np.int64)
        for t in range(128):
            w, lane = divmod(t, 32)
            g, t2 = lane // 4, 2 * (lane % 4)
            for r in range(4):
                for e in range(2):
                    frag[16 * w + g + 8 * (r % 2), 8 * (r // 2) + t2 + e] = \
                        regs[t, 8 * kc + 2 * r + e]
        np.testing.assert_array_equal(frag, p_mat[:, 16 * kc: 16 * kc + 16])
        o += frag @ read_n_major(vs, kc * 2048, width, pl.bkv * 128)
    np.testing.assert_array_equal(o[:, :d], p_mat @ v)
    assert not o[:, d:].any()


@pytest.mark.parametrize("d", range(8, fa.MAX_HEAD_DIM + 1, 8))
def test_plan_fits_shared_memory_and_registers(d):
    """For every head_dim the kernel takes: the Q tile, the ring and the
    barriers fit 227 KB with at least two stages; every panel starts on a
    1024-byte swizzle atom; a box spans at most 256 rows; a consumer's data
    (O, S and P) leaves room within its 240 registers; the three
    warpgroups' registers fit the SM."""
    pl = fa.plan(d)
    dp = -(-d // 64)
    assert pl.bq == 128 and pl.bkv == (128 if d <= 128 else 64)
    assert 2 <= pl.stages <= fa.MAX_STAGES and pl.smem <= fa.SMEM_LIMIT
    assert pl.smem == dp * pl.bq * 128 + pl.stages * 2 * dp * pl.bkv * 128 + 1024 + 8 * 14
    assert (pl.bq * 128) % 1024 == 0 and (pl.bkv * 128) % 1024 == 0
    assert pl.bq <= 256 and pl.bkv <= 256
    # O (64 x d rounded up to 64, fp32), S (64 x bkv fp32) and P (64 x bkv
    # bf16) over 128 threads, and some 24 registers of addresses and state
    data = -(-d // 64) * 32 + pl.bkv // 2 + pl.bkv // 4
    assert data + 24 <= fa.CONSUMER_REGS
    assert (fa.PRODUCER_REGS + 2 * fa.CONSUMER_REGS) * 128 <= 65536
    if pl.stages < fa.MAX_STAGES:  # one stage more would not fit
        assert pl.smem + 2 * dp * pl.bkv * 128 > fa.SMEM_LIMIT


# ------------------------------------------------------------------ walk --


def first_live(qp, window):
    return max(0, qp - window + 1) if window >= 0 else 0


def last_live(qp, causal, kv_live):
    return min(kv_live - 1, qp) if causal else kv_live - 1


def has_live(qp, causal, window, kv_live):
    return first_live(qp, window) <= last_live(qp, causal, kv_live)


def tile_range(q0, Tq, bkv, q_offset, causal, window, kv_live, n_visit, bq=128):
    """The kernel's ``tile_range``: the key tiles a block walks.  Every row
    has a live key when the first and the last row do."""
    qa, qb = q_offset + q0, q_offset + min(q0 + bq, Tq) - 1
    k0, k1 = 0, n_visit
    if has_live(qa, causal, window, kv_live) and has_live(qb, causal, window, kv_live):
        k0 = first_live(qa, window)
        k1 = min(k1, last_live(qb, causal, kv_live) + 1)
    return k0 // bkv, (-(-k1 // bkv) if k1 > 0 else 0)


def tiles_of_block(blk, grid, n_tiles):
    """The kernel's ``tile_of``: block blk's tiles, round by round, the
    rounds alternately forward and backward over the blocks."""
    out, k = [], 0
    while True:
        tau = k * grid + (grid - 1 - blk if k & 1 else blk)
        if tau >= n_tiles:
            return out
        out.append(tau)
        k += 1


@pytest.mark.parametrize("B,Hq,Tq", [(1, 1, 1), (2, 3, 200), (1, 10, 2048), (8, 15, 1024),
                                     (1, 16, 4096)])
def test_persistent_blocks_cover_every_row_once_longest_first(B, Hq, Tq):
    """min(tiles, 132) persistent blocks walk every (b, head, query) once;
    the tiles run longest rows first (causal), and the snake order keeps
    the busiest block within one tile of the average."""
    n_qt, n_bh = -(-Tq // 128), B * Hq
    n_tiles = n_bh * n_qt
    grid = min(n_tiles, 132)

    def length(tau):
        j0, j1 = tile_range(128 * (n_qt - 1 - tau // n_bh), Tq, 128, 0, True, -1, Tq, Tq)
        return j1 - j0

    seen = np.zeros((B, Hq, n_qt * 128), dtype=np.int64)
    work = []
    for blk in range(grid):
        taus = tiles_of_block(blk, grid, n_tiles)
        for tau in taus:
            qt, bh = n_qt - 1 - tau // n_bh, tau % n_bh
            seen[bh // Hq, bh % Hq, 128 * qt: 128 * qt + 128] += 1
        work.append(sum(length(t) for t in taus))
    assert (seen == 1).all()
    lengths = [length(t) for t in range(n_tiles)]
    assert lengths == sorted(lengths, reverse=True)
    assert max(work) <= sum(work) / grid + max(lengths)


@pytest.mark.parametrize("seed", range(20))
def test_live_rows_form_one_interval(seed):
    """The positions with a live key are one interval, so testing a
    block's first and last row tests them all."""
    rng = np.random.default_rng(seed)
    causal = bool(rng.integers(2))
    window = int(rng.choice([-1, 0, 1, 5, 40, 300]))
    kv_live = int(rng.integers(-2, 700))
    live = [has_live(qp, causal, window, kv_live) for qp in range(-5, 1200)]
    changes = sum(x != y for x, y in zip(live, live[1:]))
    assert changes <= 2 and not (changes == 2 and live[0])


@pytest.mark.parametrize("seed", range(40))
def test_tile_range_holds_every_live_key(seed):
    """At 128 queries, against each row's own live keys: the walked tiles
    hold every live key of every row when each row has one; else they are
    every visited tile."""
    rng = np.random.default_rng(seed)
    Tq = int(rng.integers(1, 400))
    bkv = int(rng.choice([64, 128]))
    causal = bool(rng.integers(2))
    window = int(rng.choice([-1, 1, 5, 40, 300]))
    q_offset = int(rng.integers(0, 300))
    kv_live = int(rng.integers(1, 700))
    n_visit = kv_live + int(rng.integers(0, 64))
    for q0 in range(0, Tq, 128):
        j0, j1 = tile_range(q0, Tq, bkv, q_offset, causal, window, kv_live, n_visit)
        rows = range(q0, min(q0 + 128, Tq))
        spans = [(first_live(q_offset + r, window), last_live(q_offset + r, causal, kv_live))
                 for r in rows]
        if all(lo <= hi for lo, hi in spans):
            for lo, hi in spans:
                assert j0 * bkv <= lo and min(hi, n_visit - 1) < j1 * bkv
        else:
            assert (j0, j1) == (0, -(-n_visit // bkv))


def bf16(x):
    """Round float32 to the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def model_flash(q, k, v, *, causal, window, q_offset, kv_live, n_visit):
    """The bf16 body's walk on (Hq, Tq, d) / (KV, Tk, d) float32 arrays:
    blocks of 128 queries, two consumers of 64, key tiles of the plan's
    bkv, masks only where ``interior`` fails (checked: every pair of an
    interior tile is live), scores in the log2 domain, P rounded to bf16."""
    Hq, Tq, d = q.shape
    KV, Tk, _ = k.shape
    G = Hq // KV
    bkv = fa.plan(d).bkv
    scale = np.float32(1.0 / math.sqrt(d))
    sl = np.float32(scale * LOG2E)
    win = -1 if window is None else window
    out = np.zeros_like(q)
    for h in range(Hq):
        for q0 in range(0, Tq, 128):
            j0, j1 = tile_range(q0, Tq, bkv, q_offset, causal, win, kv_live, n_visit)
            for c in range(2):
                r0 = q0 + 64 * c
                if r0 >= Tq:
                    continue
                rows = np.arange(r0, min(r0 + 64, Tq))
                qp = q_offset + rows
                lo = np.array([first_live(x, win) for x in qp])[:, None]
                hi = np.array([last_live(x, causal, kv_live) for x in qp])[:, None]
                wq_lo, wq_hi = q_offset + r0, q_offset + rows[-1]
                m2 = np.full(len(rows), NEG_INF2, dtype=np.float32)
                lsum = np.zeros(len(rows), dtype=np.float32)
                o = np.zeros((len(rows), d), dtype=np.float32)
                for j in range(j0, j1):
                    kv0 = j * bkv
                    keys = np.arange(kv0, kv0 + bkv)[None, :]
                    kt = np.zeros((bkv, d), dtype=np.float32)
                    vt = np.zeros((bkv, d), dtype=np.float32)
                    n = max(0, min(bkv, Tk - kv0))
                    kt[:n], vt[:n] = k[h // G, kv0: kv0 + n], v[h // G, kv0: kv0 + n]
                    s = (q[h, rows] @ kt.T).astype(np.float32)
                    live = (keys >= lo) & (keys <= hi)
                    interior = (kv0 + bkv <= kv_live and kv0 + bkv <= n_visit
                                and (not causal or kv0 + bkv - 1 <= wq_lo)
                                and (win < 0 or wq_hi - kv0 < win))
                    if interior:
                        assert live.all() and kv0 + bkv <= n_visit
                        mx = s.max(axis=1) * sl
                        cmul = sl
                    else:
                        y = s * sl
                        s = np.where(keys >= n_visit, -np.inf,
                                     np.where(live, y, NEG_INF2)).astype(np.float32)
                        mx = s.max(axis=1)
                        cmul = np.float32(1.0)
                    m_new = np.maximum(m2, mx)
                    corr = np.exp2(m2 - m_new)
                    p = np.exp2(s * cmul - m_new[:, None]).astype(np.float32)
                    lsum = lsum * corr + p.sum(axis=1)
                    o = o * corr[:, None] + bf16(p) @ vt
                    m2 = m_new
                out[h, rows] = o / np.maximum(lsum, np.float32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("case", [
    dict(Tq=200, Tk=333, d=64, G=3, kw={}),
    dict(Tq=200, Tk=333, d=40, G=1, kw=dict(causal=False)),
    dict(Tq=150, Tk=260, d=256, G=2, kw=dict(window=20, bk=32)),
    dict(Tq=70, Tk=300, d=128, G=2, kw=dict(q_offset=133, kv_len=290, bk=48)),
    dict(Tq=64, Tk=40, d=16, G=2, kw=dict(window=16, bk=32)),  # rows with no live key
    dict(Tq=40, Tk=333, d=64, G=1, kw=dict(causal=False, window=5, q_offset=400,
                                             kv_len=333)),  # no row has a live key
    dict(Tq=300, Tk=300, d=192, G=1, kw=dict(window=130, bk=300)),
])
def test_kernel_walk_matches_the_plain_version(case):
    """The model of the bf16 body against ``flash_attention_plain`` on the
    same bf16 inputs: each (head, query) row within 1e-2 of its norm (P
    rounded to bf16 at other tile boundaries), which covers rows with no
    live key (the mean of the visited V rows)."""
    Tq, Tk, d, G = case["Tq"], case["Tk"], case["d"], case["G"]
    kw = dict(case["kw"])
    bk = min(kw.pop("bk", 512), Tk)
    KV = 2
    g = torch.Generator().manual_seed(Tq + Tk + d)
    q, k, v = (torch.randn(s, generator=g).bfloat16()
               for s in ((1, KV * G, Tq, d), (1, KV, Tk, d), (1, KV, Tk, d)))
    want = fa.flash_attention_plain(q, k, v, bk=bk, **kw)[0].float().numpy()
    kv_live, n_visit = fa.key_bounds(Tk, bk, kw.get("kv_len"))
    got = model_flash(q[0].float().numpy(), k[0].float().numpy(), v[0].float().numpy(),
                      causal=kw.get("causal", True), window=kw.get("window"),
                      q_offset=kw.get("q_offset", 0), kv_live=kv_live, n_visit=n_visit)
    err = np.linalg.norm(got - want, axis=-1) / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)
    assert float(err.max()) <= 1e-2, float(err.max())
