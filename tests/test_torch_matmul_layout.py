"""A numpy model of the bf16 GEMM kernel (``csrc/matmul.cu``,
``gemm_tc_kernel``) on the CPU, against a numpy product, and its plan.

The kernel cannot run here, so its index arithmetic is rehearsed: the
model follows the kernel's own formulas step by step, with each hardware
unit reduced to what the kernel assumes of it:

- TMA writes a 2-D box row by row (64 bf16 = 128 bytes a row), zeros
  outside the matrix, each 16-byte chunk moved by the 128-byte swizzle
  (bits 4-6 XORed with bits 7-9); the masked path stores each element at
  the same swizzled address;
- the wgmma descriptors: K-major (``desc_k128``: element (r, k) of a k16
  step at ``start + (r // 8) * 1024 + (r % 8) * 128 + 2 k``, ``start``
  32 bytes on a step) for the activations and for a (N, K) weight, and
  M-major (``desc_b128``: element (n, k) at ``start + (n // 64) * LBO +
  (k // 8) * 1024 + (k % 8) * 128 + 2 (n % 64)``, ``start`` 2048 bytes on a
  step, transposed by the instruction) for a (K, N) weight; the swizzle is
  applied to the address so computed;
- wgmma m64nNk16 with the operands swapped: D (64 output columns x N = the
  M tile) += W (64 x 16) X^T (16 x N); thread T of warp w holds d[4 j + 2 i
  + e] = D[16 w + T / 4 + 8 i, 8 j + 2 (T % 4) + e];
- the cluster's partials: a thread's fragment at ``e * 128 + T``, added
  by rank 0 in rank order; the staging tile ``[m][n]`` with rows of
  ``STG_LD`` floats, stored 8 columns a thread, and the checksums summed
  down each column, rows in order.

Inputs are small integers, so every sum is exact and the model must equal
the product bit for bit.  The order of the sums, which decides the bits on
the card, is checked on its own: every body adds the same chunks of K, the
same k16 steps in each, in the same order, whatever M is.
"""

import numpy as np
import pytest

from repro_torch import hw
from repro_torch.kernels.matmul import matmul as mm
from repro_torch.kernels.matmul import ops

STG = mm.STG_LD


def swizzle(a):
    """``hopper::swizzle(a, 7)``: the 128-byte swizzle of a byte offset."""
    return a ^ (((a >> 7) & 7) << 4)


def tma_box(smem, dst, mat, r0, c0, rows, cols=64):
    """TMA's 2-D box of ``rows`` x ``cols`` at (r0, c0) of ``mat`` (rows of
    the outer dim, ``cols`` of the inner), zeros outside, written at the
    1024-byte aligned byte ``dst`` of ``smem`` (one int per bf16)."""
    assert dst % 1024 == 0 and cols * 2 == 128
    r, c = np.indices((rows, cols))
    gr, gc = r0 + r, c0 + c
    inside = (gr < mat.shape[0]) & (gc < mat.shape[1])
    vals = np.where(inside, mat[np.minimum(gr, mat.shape[0] - 1),
                                np.minimum(gc, mat.shape[1] - 1)], 0)
    smem[(dst + swizzle(r * 128 + c * 2)) // 2] = vals


def masked_stage(smem, xs, ws, a, b, trans_b, m0, n0, k0, bm, wgs):
    """The producer warpgroup's masked loads, element by element as the
    kernel's loops index them (``produce``)."""
    M, K = a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    for i in range(bm * 64):
        r, kk = divmod(i, 64)
        gm, gk = m0 + r, k0 + kk
        smem[swizzle(xs + r * 128 + kk * 2) // 2] = a[gm, gk] if gm < M and gk < K else 0
    for i in range(wgs * 64 * 64):
        if trans_b:
            r, kk = divmod(i, 64)
            gn, gk = n0 + r, k0 + kk
            v = b[gn, gk] if gn < N and gk < K else 0
            smem[swizzle(ws + r * 128 + kk * 2) // 2] = v
        else:
            w, j = divmod(i, 64 * 64)
            kr, nc = divmod(j, 64)
            gn, gk = n0 + w * 64 + nc, k0 + kr
            v = b[gk, gn] if gn < N and gk < K else 0
            smem[swizzle(ws + w * mm.W_BOX_BYTES + kr * 128 + nc * 2) // 2] = v


def desc_k(start, rows):
    """Byte offsets of a (rows x 16) K-major operand through ``desc_k128``."""
    r, k = np.indices((rows, 16))
    return start + (r // 8) * 1024 + (r % 8) * 128 + 2 * k


def desc_mn(start, lbo):
    """Byte offsets of a (64 x 16) M-major operand through ``desc_b128``."""
    n, k = np.indices((64, 16))
    return start + (n // 64) * lbo + (k // 8) * 1024 + (k % 8) * 128 + 2 * (n % 64)


def frag_index(nreg):
    """(row, column) of D that thread T's register r holds, as (128, nreg)
    arrays: d[4 j + 2 i + e] = D[16 w + T / 4 + 8 i, 8 j + 2 (T % 4) + e]."""
    t, r = np.indices((128, nreg))
    w, lane = t // 32, t % 32
    j, i, e = r // 4, (r % 4) // 2, r % 2
    return 16 * w + lane // 4 + 8 * i, 8 * j + 2 * (lane % 4) + e


def fragment(D):
    """(128 threads, N / 2) accumulator fragment of a 64 x N tile D."""
    rows, cols = frag_index(D.shape[1] // 2)
    return D[rows, cols]


class Kernel:
    """The bf16 kernel on one call, with a trace of the order in which every
    output's sums are taken: ``order[n // 64]`` the (chunk, panel, k16 step)
    sequence, chunk by chunk, in the order the chunks are added."""

    def __init__(self, a, b, trans_b, tma=True):
        self.a, self.b, self.trans_b, self.tma = a, b, trans_b, tma
        self.M, self.K = a.shape
        self.N = b.shape[0] if trans_b else b.shape[1]
        self.p = mm.plan(self.M, self.N, self.K, trans_b)
        self.wgs = 1 if self.p.body == "skinny" else 2      # consumer warpgroups
        self.wn = self.p.bn // 64                           # weight boxes a stage
        self.mt = self.p.bm // self.wgs if self.wn < self.wgs else self.p.bm
        self.kp = -(-self.K // mm.PANEL_K)
        self.stage_bytes = self.wn * mm.W_BOX_BYTES + self.p.bm * 128
        self.order: dict[int, list] = {}

    def load_stage(self, m0, n0, k0):
        """One ring stage (the weight boxes, then the activation box) as
        TMA or the masked path writes it; returns (smem, x offset)."""
        smem = np.zeros(self.stage_bytes // 2, dtype=np.int64)
        ws, xs = 0, self.wn * mm.W_BOX_BYTES
        bm = self.p.bm
        if self.tma:
            if self.trans_b:
                tma_box(smem, ws, self.b, n0, k0, self.wn * 64)
            else:
                for w in range(self.wn):  # the (K, N) weight: rows k of 64 n
                    tma_box(smem, ws + w * mm.W_BOX_BYTES, self.b, k0, n0 + 64 * w, 64)
            tma_box(smem, xs, self.a, m0, k0, bm)
        else:
            masked_stage(smem, xs, ws, self.a, self.b, self.trans_b, m0, n0, k0, bm, self.wn)
        return smem, xs

    def chunk(self, cw, m0, n0, c):
        """``consume`` on chunk c: a fresh fragment, every panel's four k16
        wgmmas from the stage's shared memory."""
        mt, split_rows = self.mt, self.wn < self.wgs
        D = np.zeros((64, mt), dtype=np.int64)
        for kq in range(mm.chunk_start(c, self.kp, self.p.split),
                        mm.chunk_start(c + 1, self.kp, self.p.split)):
            smem, xs = self.load_stage(m0, n0, kq * mm.PANEL_K)
            # its own 64 weight rows, or its own mt activation rows
            wa = 0 if split_rows else cw * mm.W_BOX_BYTES
            xa = xs + (cw * mt * 128 if split_rows else 0)
            for kk in range(4):
                if self.trans_b:
                    w_off = desc_k(wa + 32 * kk, 64)
                else:
                    w_off = desc_mn(wa + 2048 * kk, mm.W_BOX_BYTES)
                x_off = desc_k(xa + 32 * kk, mt)
                W = smem[swizzle(w_off) // 2]          # (64 n, 16 k)
                X = smem[swizzle(x_off) // 2]          # (mt m, 16 k)
                D += W @ X.T
                col = (n0 + (0 if split_rows else 64 * cw)) // 64
                self.order.setdefault(col, []).append((c, kq, kk))
        return fragment(D)

    def epilogue(self, acc, m0, nb, C, checks):
        """``epilogue``: a consumer's mt x 64 tile at rows m0, columns nb
        into the staging tile, rows stored 8 columns a thread, checksums
        down each column."""
        bm, M, N = self.mt, self.M, self.N
        n_l, m_l = frag_index(bm // 2)     # the fragment's (column of C, row of C)
        stg = np.zeros(bm * STG, dtype=np.int64)
        stg[m_l * STG + n_l] = acc
        for idx in range(bm * 8):
            r, c8 = idx // 8, (idx % 8) * 8
            gm, gn = m0 + r, nb + c8
            if gm >= M or gn >= N:
                continue
            e = min(8, N - gn)
            C[gm, gn:gn + e] = stg[r * STG + c8:r * STG + c8 + e]
        abft_bm = mm.abft_block_rows(M)
        for ct in range(64):
            if nb + ct >= N:
                continue
            rs = 0
            while rs < bm and m0 + rs < M:
                rows = min(M - m0 - rs, abft_bm, bm - rs)
                checks[(m0 + rs) // abft_bm, nb + ct] = sum(
                    stg[(rs + r) * STG + ct] for r in range(rows))
                rs += abft_bm

    def run(self):
        p, M, N = self.p, self.M, self.N
        C = np.full((M, N), -1, dtype=np.int64)
        checks = np.full((-(-M // mm.abft_block_rows(M)), N), -1, dtype=np.int64)
        m_tiles = -(-M // p.bm)
        ntiles = -(-N // p.bn) * m_tiles
        if p.body == "skinny":
            assert m_tiles == 1 and p.grid == ntiles * p.split
            for tile in range(ntiles):
                # rank r of the cluster: chunk r; rank 0 adds the peers in order
                frags = [self.chunk(0, 0, tile * 64, r) for r in range(p.split)]
                peers = [f.T.reshape(-1) for f in frags]      # e * 128 + T
                acc = frags[0].copy()
                for r in range(1, p.split):
                    acc = acc + peers[r].reshape(-1, 128).T
                self.epilogue(acc, 0, tile * 64, C, checks)
        else:
            split_rows = self.wn < self.wgs
            for block in range(p.grid):
                for tile in range(block, ntiles, p.grid):
                    m0, n0 = (tile % m_tiles) * p.bm, (tile // m_tiles) * p.bn
                    for cw in range(2):
                        acc = None
                        for c in range(p.split):
                            part = self.chunk(cw, m0, n0, c)
                            acc = part.copy() if c == 0 else acc + part
                        self.epilogue(acc, m0 + (cw * self.mt if split_rows else 0),
                                      n0 + (0 if split_rows else 64 * cw), C, checks)
        return C, checks


def _ints(shape, rng):
    return rng.integers(-3, 4, size=shape).astype(np.int64)


def _want(a, b, trans_b):
    c = a @ (b.T if trans_b else b)
    M = a.shape[0]
    bm = mm.abft_block_rows(M)
    nrb = -(-M // bm)
    pad = np.zeros((nrb * bm, c.shape[1]), dtype=np.int64)
    pad[:M] = c
    return c, pad.reshape(nrb, bm, -1).sum(1)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [
    (1, 64, 64), (8, 200, 130), (9, 70, 100), (17, 128, 192), (40, 37, 49),
    (64, 130, 64), (65, 200, 130), (130, 64, 260), (300, 16, 8450),
])
def test_model_equals_the_product(M, K, N, trans_b):
    """The whole walk (TMA boxes, descriptors, swapped wgmma, cluster
    combine or chunk totals, staging, masked stores, checksums) equals the
    product and its row-block column sums, on both bodies, with K split and
    (300, 16, 8450: one panel) unsplit."""
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    a = _ints((M, K), rng)
    b = _ints((N, K) if trans_b else (K, N), rng)
    C, checks = Kernel(a, b, trans_b).run()
    want, want_checks = _want(a, b, trans_b)
    np.testing.assert_array_equal(C, want)
    np.testing.assert_array_equal(checks, want_checks)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [(9, 70, 130), (100, 70, 130), (3, 37, 70)])
def test_masked_path_writes_what_tma_writes(M, K, N, trans_b):
    """Where TMA cannot take an operand (the reference grid's (100, 130,
    70): a 140-byte row), the producer's masked loads fill every stage
    with the TMA box's bytes, so the product is the same."""
    rng = np.random.default_rng(7 + M)
    a = _ints((M, K), rng)
    b = _ints((N, K) if trans_b else (K, N), rng)
    tma, masked = Kernel(a, b, trans_b), Kernel(a, b, trans_b, tma=False)
    for m0, n0, k0 in [(0, 0, 0), (0, 64, 64)]:
        s1, _ = tma.load_stage(m0, n0, k0)
        s2, _ = masked.load_stage(m0, n0, k0)
        np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(masked.run()[0], _want(a, b, trans_b)[0])


@pytest.mark.parametrize("K,N", [(960, 960), (960, 320), (960, 2560), (2560, 960),
                                 (70, 130), (200, 49)])
def test_every_body_sums_in_the_same_order(K, N):
    """A row's bits depend on the order of its sums alone: every M, across
    the skinny/wide switch at 64 -> 65 and the wide body's 64- and 128-row
    tiles, takes the same chunks of K, the same (panel, k16 step) sequence
    in each, added in chunk order.  Traced on the model at a cut K and N
    where the full shape would be slow, the plan's split taken at the full
    shape."""
    orders = []
    for M in (1, 8, 9, 16, 17, 40, 64, 65, 128, 129):
        p = mm.plan(M, N, K)
        assert p.split == mm.k_split(N, K)
        kp = -(-K // mm.PANEL_K)
        seq = [(c, kq, kk) for c in range(p.split)
               for kq in range(mm.chunk_start(c, kp, p.split), mm.chunk_start(c + 1, kp, p.split))
               for kk in range(4)]
        orders.append(seq)
    assert all(o == orders[0] for o in orders)
    # the model's own trace at a small shape with the same split
    rng = np.random.default_rng(3)
    Ks, Ns = min(K, 256), min(N, 130)
    traces = []
    for M in (8, 65, 130):
        a = _ints((M, Ks), rng)
        k = Kernel(a, _ints((Ks, Ns), rng), False)
        k.run()
        traces.append({n: t for n, t in k.order.items()})
    for t in traces[1:]:
        for n, want in traces[0].items():  # the wide body's tile past N is never stored
            # a wide column tile repeats the sequence once per M tile
            seq = t[n]
            assert len(seq) % len(want) == 0
            assert all(seq[i:i + len(want)] == want for i in range(0, len(seq), len(want)))


SERVE = [(960, 960, False), (960, 320, False), (960, 2560, False), (2560, 960, False),
         (960, 49152, True)]


@pytest.mark.parametrize("K,N,trans_b", SERVE)
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 40, 64, 65, 128, 129, 300, 2176, 2177])
def test_plan_fits_the_card(M, K, N, trans_b):
    """Shared memory within 227 KB; the accumulators within the register
    budget (skinny: 256 threads, 2-3 blocks an SM, 80-128 registers; wide:
    224 a consumer thread after setmaxnreg, 128 of them the chunk's and
    the total's accumulators); the split from (N, K) alone and
    whole chunks of 64-k panels; the grid at least one block an SM, or the
    split at the cluster's cap."""
    p = mm.plan(M, N, K, trans_b)
    assert p.smem <= hw.SMEM_PER_BLOCK_BYTES
    assert p.split == mm.k_split(N, K) == mm.plan(8, N, K).split
    kp = -(-K // mm.PANEL_K)
    assert 1 <= p.split <= min(mm.MAX_SPLIT, kp)
    sizes = [mm.chunk_start(c + 1, kp, p.split) - mm.chunk_start(c, kp, p.split)
             for c in range(p.split)]
    assert min(sizes) >= 1 and sum(sizes) == kp
    mt = mm.wide_rows(p.bn) if p.body == "wide" else p.bm   # a consumer's rows
    acc_regs = mt // 2 * (2 if p.body == "wide" and p.split > 1 else 1)
    assert p.body == "skinny" or (p.bm == 128 and p.bn == mm.wide_bn(mm.m_bucket(M), N))
    if p.body == "skinny":
        assert M <= mm.SKINNY_MAX_M and p.bm >= M and acc_regs <= 32
        assert p.stages >= min(max(sizes), mm.SKINNY_MAX_STAGES)  # a chunk in flight at once
        blocks_per_sm = hw.SMEM_PER_SM_BYTES // (p.smem + hw.SMEM_RESERVED_PER_BLOCK_BYTES)
        assert blocks_per_sm >= 1
    else:
        assert M > mm.SKINNY_MAX_M and acc_regs <= 128 and p.stages >= 2
    tiles = -(-N // p.bn) * (1 if p.body == "skinny" else -(-M // p.bm))
    if p.body == "skinny":
        # no split finishes sooner, and the grid's waves x panels are within
        # 2x of every SM taking an equal share of all the panels
        nt = -(-N // mm.TILE_N)
        t = mm.split_time(N, K, p.split)
        assert all(mm.split_time(N, K, s) >= t for s in range(1, min(mm.MAX_SPLIT, kp) + 1))
        assert t <= 2 * -(-nt * kp // hw.SM_COUNT)
    else:
        assert p.grid == min(hw.SM_COUNT, -(-N // p.bn) * -(-mm.m_bucket(M) // p.bm))
        assert p.grid >= min(hw.SM_COUNT, tiles)


def test_plan_is_keyed_on_the_m_bucket():
    """Equal buckets give equal plans (the plan is cached per bucket, never
    per M): 9..16, 17..32, 33..64, then 128 rows at a time, and past the
    cap."""
    for lo, hi in [(1, 8), (9, 16), (17, 32), (33, 64), (65, 128), (2049, 2176),
                   (16385, 40000)]:
        for K, N, trans_b in SERVE:
            ref = mm.plan(lo, N, K, trans_b)
            assert mm.plan(hi, N, K, trans_b) == ref
            assert mm.plan((lo + hi) // 2, N, K, not trans_b) == ref
    assert mm.plan(16, 960, 960) != mm.plan(17, 960, 960)
    assert mm.m_bucket(1) == 8 and mm.m_bucket(65) == 128 and mm.m_bucket(2176) == 2176
    assert mm.m_bucket(2177) == 2304 and mm.m_bucket(10**6) == mm.MAX_BUCKET


def test_serve_plans():
    """smollm-360m's five projections at decode M (8) and a prefill M: the
    skinny body splits the small N across clusters of 8 (960: 120 blocks,
    320: 40), 2560 across 3 (120 blocks of 5 panels, one wave, against 160
    of 4 in two), and streams the unembedding's 768 tiles unsplit; the wide
    body runs a persistent grid of up to 132 with the tile whose rounds over
    the SMs load the fewest L2 bytes."""
    got = {(K, N): mm.plan(8, N, K, t) for K, N, t in SERVE}
    assert [(p.split, p.grid) for p in got.values()] == [(8, 120), (8, 40), (3, 120), (8, 120),
                                                         (1, 768)]
    assert all(p.body == "skinny" and p.bm == 8 for p in got.values())
    wide = [mm.plan(2176, N, K, t) for K, N, t in SERVE]
    assert all(p.body == "wide" and p.bm == 128 for p in wide)
    # 64 columns where 128 would leave a second round nearly empty (N = 960:
    # 136 tiles of 128 on 132 SMs, 255 of 64 in two full rounds)
    assert [p.bn for p in wide] == [64, 64, 128, 64, 128]
    assert [p.grid for p in wide] == [132, 85, 132, 132, 132]


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        mm.plan(0, 8, 8)
    assert mm.plan(4, 8, 0).split == 1


@pytest.mark.parametrize("K,N", [(960, 960), (960, 320), (960, 2560), (2560, 960), (960, 49152),
                                 (70, 130), (64, 49), (4096, 4096), (2048, 8192), (8192, 2048),
                                 (2560, 7680), (7680, 2560)])
def test_the_blocking_search_picks_the_plans_split(K, N):
    """The paper's blocking search on the GEMM nest over the H100's levels
    (``ops.gemm_search``), timed in waves over 132 SMs, picks the split the
    plan gives the kernel (``k_split``); its schedule is the kernel's: the
    grid's 64-column tiles and chunks, the chunk's panels through L2, one
    64-k panel a ring stage."""
    got = ops.gemm_search(N, K)
    assert got.split == mm.k_split(N, K)
    tiling = got.report.schedule.tiling
    kp = -(-K // mm.PANEL_K)
    assert tiling["N"][3] == -(-N // mm.TILE_N) and tiling["K"][3] == got.split
    assert tiling["K"][1] == mm.PANEL_K and tiling["K"][2] == -(-kp // got.split)
