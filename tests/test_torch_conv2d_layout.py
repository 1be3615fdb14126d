"""A numpy model of the bf16 conv kernel (``csrc/conv2d.cu``,
``conv2d_tc_kernel``) on the CPU, against a direct im2col product.

The kernel cannot run here, so its index arithmetic is rehearsed: the
model follows the kernel's own formulas step by step, with each hardware
unit reduced to what the kernel assumes of it:

- TMA writes a box in row-major order of its dims, one row of the
  innermost dim after another, zeros outside the tensor, each 16-byte
  chunk moved by the swizzle (bits 4.. XORed with the bits from 7 up: a
  32-, 64- or 128-byte span for 16-, 32- or 64-channel rows);
- ``ldmatrix.x4``: matrix m's row r is the 16 bytes at lane 8 m + r's
  address; the warp's A fragment is (rows 0-7, 8-15) x (columns 0-7, 8-15)
  of matrices 0-3;
- the wgmma B descriptor (N-major, 128-byte swizzle; one m64nNk16 with N
  = bk for one or two panels, one m64n64k16 per panel for three or four):
  element (k, n) of a 16 x N tile at ``start + (n // 64) * LBO + (k // 8) * SBO + (k % 8) * 128
  + 2 (n % 64)`` before the swizzle (LBO: from one 64-column panel to the
  next; SBO: from one 8-row group to the next);
- the wgmma accumulator: thread T of warp w holds d[4 j + 2 i + e] = D[16 w
  + T / 4 + 8 i, 8 j + 2 (T % 4) + e].

Inputs are small integers, so every sum is exact and the model must equal
the product bit for bit.  It covers bc of 16, 32 and 64 (the three swizzle
spans), one to four panels, several images per block, ragged pixel, C and
K edges, C below one step (padded, as the wrapper pads it) and non-square
filters.
"""

import numpy as np
import pytest

from repro_torch import hw
from repro_torch.kernels.conv2d.conv2d import TC_ROWS, ConvTiles

PANEL = hw.CONV_PANEL


def swizzle(a, mask):
    """``hopper::swizzle``: the byte offset as TMA's swizzle stores it."""
    return a ^ (((a >> 7) & mask) << 4)


def tma_box(smem, dst, tensor, coords, box, mask):
    """Write ``tensor``'s box at ``coords`` (numpy's dim order: the
    innermost TMA dim last) into ``smem`` (one int per bf16 element,
    indexed by byte offset / 2) at the 1024-byte aligned byte ``dst``: rows
    of ``box[-1]`` elements in row-major order, zeros outside the tensor,
    swizzled."""
    assert dst % 1024 == 0
    idx = np.indices(box).reshape(len(box), -1)
    pos = idx + np.array(coords)[:, None]
    inside = np.all((pos >= 0) & (pos < np.array(tensor.shape)[:, None]), axis=0)
    vals = np.zeros(idx.shape[1], dtype=np.int64)
    vals[inside] = tensor[tuple(pos[:, inside])]
    row = np.ravel_multi_index(tuple(idx[:-1]), box[:-1])
    smem[(dst + swizzle(row * 2 * box[-1] + 2 * idx[-1], mask)) // 2] = vals


def desc_offsets(start, width, lbo, sbo=1024):
    """Byte offsets of a 16 x ``width`` B tile's elements through the
    descriptor (before the swizzle, from a 1024-byte atom's base)."""
    k = np.arange(16)[:, None]
    n = np.arange(width)[None, :]
    return start + (n // PANEL) * lbo + (k // 8) * sbo + (k % 8) * 128 + 2 * (n % PANEL)


def model_conv(x, w, t: ConvTiles):
    """The kernel's arithmetic on integer arrays: x (B, H, W, C), w (FX,
    FY, C, K), after the wrapper's padding; returns (B, Ho, Wo, K)."""
    x, w, C = pad_like_wrapper(x, w, t.bc)
    B, H, W, _ = x.shape
    FX, FY, _, K = w.shape
    Ho, Wo = H - FX + 1, W - FY + 1
    IH, IW = t.bx + FX - 1, t.by + FY - 1
    NP = t.bk // PANEL
    in_box = 2 * t.nb * IH * IW * t.bc
    in_bytes = -(-in_box // 1024) * 1024
    panel_bytes = FX * FY * t.bc * 128
    assert in_bytes + NP * panel_bytes == t.stage_bytes(FX, FY)
    mask = t.bc // 8 - 1
    wt = w.reshape(FX * FY, C, K)  # the tensor map's (K, C, FX FY) view
    tiles_w = -(-Wo // t.by)
    npt, nkt = -(-Ho // t.bx) * tiles_w, -(-K // t.bk)
    out = np.zeros((B, Ho, Wo, K), dtype=np.int64)
    stored = np.zeros(out.shape, dtype=bool)
    npix = t.nb * t.bx * t.by
    for bid in range(npt * -(-B // t.nb) * nkt):
        kt, rest = bid % nkt, bid // nkt
        pt, bt = rest % npt, rest // npt
        h0, w0 = (pt // tiles_w) * t.bx, (pt % tiles_w) * t.by
        b0, k0 = bt * t.nb, kt * t.bk
        acc = np.zeros((TC_ROWS, t.bk), dtype=np.int64)
        for n in range(-(-C // t.bc)):
            smem = np.zeros(t.stage_bytes(FX, FY) // 2, dtype=np.int64)
            tma_box(smem, 0, x, (b0, h0, w0, n * t.bc), (t.nb, IH, IW, t.bc), mask)
            for q in range(NP):
                tma_box(smem, in_bytes + q * panel_bytes, wt, (0, n * t.bc, k0 + q * PANEL),
                        (FX * FY, t.bc, PANEL), 7)
            for cw in range(TC_ROWS // 16):  # consumer warps
                lanes = np.arange(32)
                r = 16 * cw + (lanes & 15)
                r = np.where(r >= npix, 0, r)
                row0 = ((r // (t.bx * t.by)) * IH + (r // t.by) % t.bx) * IW + r % t.by
                lane_col = 16 * (lanes >> 4)
                for fx in range(FX):
                    for fy in range(FY):
                        row = row0 + fx * IW + fy
                        w_tap = in_bytes + (fx * FY + fy) * t.bc * 128
                        for ks in range(0, t.bc, 16):
                            a_addr = swizzle(row * 2 * t.bc + 2 * ks + lane_col, mask)
                            frag = ldmatrix_x4(smem, a_addr)  # (16, 16) of this warp
                            # one m64nNk16 (N = bk) up to two panels, else one per panel
                            width = t.bk if NP <= 2 else PANEL
                            for q in range(t.bk // width):
                                start = w_tap + ks * 128 + q * panel_bytes
                                off = desc_offsets(start % 1024, width, panel_bytes)
                                b = smem[(start - start % 1024 + swizzle(off, 7)) // 2]
                                acc[16 * cw: 16 * cw + 16, q * width: (q + 1) * width] += frag @ b
        epilogue(out, stored, acc, t, b0, h0, w0, k0, npix)
    assert stored.all(), "an output was never stored"
    return out


def ldmatrix_x4(smem, addr):
    """Matrix m's row r from lane 8 m + r's 16 bytes; (rows, columns) of
    the warp's 16 x 16 A fragment."""
    frag = np.zeros((16, 16), dtype=np.int64)
    for m in range(4):
        for r in range(8):
            a = addr[8 * m + r]
            assert a % 16 == 0
            frag[8 * (m % 2) + r, 8 * (m // 2): 8 * (m // 2) + 8] = smem[a // 2: a // 2 + 8]
    return frag


def epilogue(out, stored, acc, t, b0, h0, w0, k0, npix):
    """Each thread's stores from its accumulator registers, masked."""
    B, Ho, Wo, K = out.shape
    for cw in range(TC_ROWS // 16):
        for lane in range(32):
            g, t2 = lane >> 2, (lane & 3) * 2
            d = {(q, 4 * j + 2 * i + e): acc[16 * cw + g + 8 * i, q * PANEL + 8 * j + t2 + e]
                 for q in range(t.bk // PANEL) for j in range(8) for i in range(2)
                 for e in range(2)}
            for i in range(2):
                rr = 16 * cw + g + 8 * i
                if rr >= npix:
                    continue
                b = b0 + rr // (t.bx * t.by)
                h, wc = h0 + (rr // t.by) % t.bx, w0 + rr % t.by
                if b >= B or h >= Ho or wc >= Wo:
                    continue
                for q in range(t.bk // PANEL):
                    for j in range(8):
                        for e in range(2):
                            k = k0 + q * PANEL + 8 * j + t2 + e
                            if k < K:
                                assert not stored[b, h, wc, k], "stored twice"
                                stored[b, h, wc, k] = True
                                out[b, h, wc, k] = d[(q, 4 * j + 2 * i + e)]


def pad_like_wrapper(x, w, bc):
    """``conv2d._pad_for_tma`` on numpy arrays (without the copy of K's
    columns the model never reads past K)."""
    C = x.shape[3]
    Cx = max(-(-C // 8) * 8, bc)
    Cw = bc if C < bc else C
    x = np.pad(x, ((0, 0),) * 3 + ((0, Cx - C),))
    w = np.pad(w, ((0, 0),) * 2 + ((0, Cw - C), (0, 0)))
    return x, w, Cw


def im2col_conv(x, w):
    B, H, W, C = x.shape
    FX, FY, _, K = w.shape
    Ho, Wo = H - FX + 1, W - FY + 1
    cols = np.stack([x[:, i: i + Ho, j: j + Wo, :] for i in range(FX) for j in range(FY)],
                    axis=3)  # (B, Ho, Wo, FX FY, C)
    return cols.reshape(B * Ho * Wo, -1) @ w.reshape(-1, K)


@pytest.mark.parametrize("B,H,W,C,K,FX,FY,tiles", [
    (1, 6, 7, 16, 64, 3, 3, (4, 5, 16, 64, 1)),      # one panel, ragged pixels
    (3, 5, 6, 40, 72, 2, 3, (2, 4, 32, 128, 2)),     # 64-byte swizzle, nb 2, ragged C, K
    (2, 4, 5, 70, 200, 1, 1, (4, 5, 64, 256, 1)),    # 128-byte swizzle, four panels, 1x1
    (2, 5, 5, 3, 5, 3, 3, (3, 3, 16, 64, 2)),        # C = 3, K = 5: padded
    (1, 9, 4, 24, 130, 3, 1, (7, 4, 32, 192, 1)),    # non-square filter, three panels
])
def test_kernel_model_equals_im2col(B, H, W, C, K, FX, FY, tiles):
    rng = np.random.default_rng(B * H + C + K)
    x = rng.integers(-3, 4, (B, H, W, C))
    w = rng.integers(-3, 4, (FX, FY, C, K))
    bx, by, bc, bk, nb = tiles
    t = ConvTiles(bx, by, bc, bk, nb, 2)
    got = model_conv(x, w, t)
    want = im2col_conv(x, w).reshape(got.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bc", [16, 32, 64])
def test_swizzled_ldmatrix_rows_hit_distinct_banks(bc):
    """Eight consecutive pixel rows (one 8 x 8 matrix of ldmatrix, as along
    a tile row) read their 16 bytes from eight distinct 16-byte groups of
    the 32 banks once swizzled: no bank conflict."""
    mask = bc // 8 - 1
    for start in range(64):
        for chunk in range(bc // 8):
            addrs = [swizzle((start + r) * 2 * bc + 16 * chunk, mask) for r in range(8)]
            assert len({(a % 128) // 16 for a in addrs}) == 8, (start, chunk)


def test_descriptor_addresses_match_the_tma_rows():
    """The B descriptor's (k, n) offsets, for every 16-row step of every
    tap, are the TMA boxes' row (tap bc + c) and column n % 64 in panel
    n // 64, the panels ``FX FY bc 128`` bytes apart."""
    bc, taps, panels = 32, 3, 4
    panel_bytes = taps * bc * 128
    for tap in range(taps):
        for ks in range(0, bc, 16):
            start = (tap * bc + ks) * 128
            assert start % 2048 == 0  # a whole number of swizzle atoms: base offset 0
            got = desc_offsets(start, panels * PANEL, panel_bytes)
            k = np.arange(16)[:, None]
            n = np.arange(panels * PANEL)[None, :]
            want = (n // PANEL) * panel_bytes + (tap * bc + ks + k) * 128 + 2 * (n % PANEL)
            np.testing.assert_array_equal(got, want)
