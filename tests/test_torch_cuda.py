"""The port's CUDA kernels and engine on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  They
import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same inputs.
Decode attention bitwise (both accumulate order-independently in fp64 and
round once: the ABFT fingerprint compares them within 1e-5 of the output
scale); the GEMM to one bf16 ulp of the output's scale.  Paged decode equals contiguous decode bitwise at
``bk == block_size``, since both run one kernel body in one order.  The
checksum GEMM's product equals the GEMM's bitwise; its checksums are held
to the plain version's within the ABFT tolerance
``ABFT_ATOL + ABFT_RTOL * (e^T|A|)|B|`` (fp32 sums in other orders) and
repeat bit for bit.  The conv2d kernel (bf16: a TMA ring feeding wgmma) is
held to its plain version within one bf16 ulp of each element plus 1e-3 of
the output's largest magnitude (both sum in fp32, in other orders, and
round once), on the reference's grid, C = 3 and K = 5 (padded for TMA),
each distinct CONV layer of the paper at batch 2, repeats bitwise, one
launch a call, misaligned operands refused.  The WKV-6 kernel is
held to its plain version within 1e-5 of the output's (and the state's)
largest magnitude: both run in fp32, the kernel's sum over the key index in
one fixed order with fused multiply-adds, the plain version's through an
fp32 einsum (TF32 is off for matmuls by default).  The linear-scan kernel
(the RG-LRU's recurrence) is held to its plain version bitwise: each step
is one rounded fp32 multiply and one rounded add in both, no FMA
contraction.  Decode attention at recurrentgemma-2b's head_dim 256 and 10
query heads per KV head is held bitwise too, on a ring whose rows are
wrapped (every slot live), paged == contiguous at ``bk == block_size``.
The decode kernel splits each row's KV across a thread-block cluster:
it is held bitwise at split counts 1 to 256 (rows ending in different
blocks), each row alone against the batch, one launch per call, and its
wrappers never synchronise the host.

The kernels take every dtype and size their Pallas kernels take: decode
attention every head_dim that is a multiple of 8 up to 256 and fp32 as
well as bf16 (fp32 within ``FP32_TOL`` = 1e-6 of the output's scale of its
plain version: fp64 sums of fp32 products rounded in two orders; paged ==
contiguous still bitwise), the GEMMs and conv2d fp32 (full fp32 on the
CUDA cores: the GEMM within 1e-5 of the output's scale, conv2d within 1e-5
of the element plus 1e-5 of the scale; the checksum GEMM's product bitwise
the GEMM's, rows independent of M), WKV-6 key and value head sizes of 16,
32 and 64 apart.  The parameter grids of the reference's
``tests/test_kernels.py`` and of ``tests/test_torch_decode_attention.py``
go through the port's ``ops`` on CUDA tensors.  The flash-attention kernel
is held to its plain version within 1e-5 of the output's scale in fp32 and
1e-2 in bf16 (p rounded to bf16 in both, at scores from sums in other
orders), its repeat runs bitwise.  Its bf16 body (a TMA ring feeding
``wgmma``, tiles from ``flash_attention.plan``) is also sent head_dims 16
to 256, up to 16 query heads per KV head, lengths that are no multiple of
its tiles, windows narrower than a key tile, rows with no live key and
views at any strides; the kernel's own plan equals the Python mirror.
The bf16 GEMM (a TMA ring feeding ``wgmma``, tiles from
``matmul.plan``) is held at smollm-360m's five projection shapes at a
decode and a prefill M, its rows bitwise equal at every M from 1 to
2176 (across the skinny/wide body switch and every M bucket) in both
layouts of B, with and without checksums, on operands TMA takes and on
those the masked path takes (a row pitch that is no multiple of 16
bytes, a misaligned base); the kernel's own plan equals the Python
mirror.  The scan's Hopper bodies (a 16-byte step body up to 8 steps, a
TMA or ``cp.async`` ring beyond) are held bitwise at T on both sides of
each threshold, D not a multiple of any tile, misaligned bases, decays 0
and 1 and in place; WKV-6's (column blocks, a ring of 16-step chunks, a
tree-ordered sum fixed by Dk) at every (Dk, Dv) pair across chunk edges,
decays 0, 1 and 1e-30, misaligned operands and in place, a row of a
B = 8, H = 32 call bitwise that row called alone; both kernels' own plans
equal the Python mirrors.  The engine's scheduler runs there too, at the
smoke config's size under ``matmul="pallas"``: the chunked-prefill lane
gives monolithic admission's tokens and a preempted request replays to
its uninterrupted tokens, bitwise at temperature 0.8.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import hw
from repro_torch.arch.layers import Dispatch
from repro_torch.arch.model_zoo import build
from repro_torch.configs.registry import get
from repro_torch.kernels import _build, abft
from repro_torch.kernels.conv2d import conv2d as cv
from repro_torch.kernels.conv2d import ops as convops
from repro_torch.kernels.flash_attention import decode_attention as dec
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.linear_scan import linear_scan as ls_mod
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan.linear_scan import (
    linear_scan_cuda,
    linear_scan_plain,
    wkv6_cuda,
    wkv6_plain,
)
from repro_torch.kernels.matmul import ops as mmops
from repro_torch.kernels.matmul.matmul import (
    abft_block_rows,
    matmul_abft_cuda,
    matmul_abft_plain,
    matmul_cuda,
    matmul_plain,
)
from repro_torch.serve import engine as te


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels do not run on the CPU)")
    return torch.device("cuda")


def _randn(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("G,d", [(1, 64), (3, 64), (2, 128)])
def test_decode_kernels_match_plain_and_agree_bitwise(cuda, G, d):
    B, S, KV, bs = 8, 256, 5, 16
    g = torch.Generator(device=cuda).manual_seed(G)
    q, k, v = (_randn(s, g, cuda) for s in ((B, KV, G, d), (B, S, KV, d), (B, S, KV, d)))
    n_blk = S // bs
    tables = (torch.randperm(B * n_blk, generator=g, device=cuda) + 1).reshape(B, n_blk)
    tables = tables.to(torch.int32)
    kpool, vpool = (_randn((B * n_blk + 1, bs, KV, d), g, cuda) for _ in "kv")
    kpool[tables.long()] = k.reshape(B, n_blk, bs, KV, d)
    vpool[tables.long()] = v.reshape(B, n_blk, bs, KV, d)
    lengths = torch.tensor([0, 1, 15, 16, 17, 100, 255, 256], dtype=torch.int32, device=cuda)
    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=bs)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    torch.cuda.synchronize()
    assert torch.equal(contig, paged)
    assert torch.equal(contig, dec.decode_attention_plain(q, k, v, lengths, bk=bs))
    assert torch.equal(paged, dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths))
    for window in (1, 7, 40):
        got = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=window)
        want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_decode_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    """The limits: q, K and V of one type, bf16 or fp32; head_dim a multiple
    of 8 up to 256; G up to 16; shared memory within 227 KB a block."""
    q = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 16, 1, 64), dtype=torch.bfloat16, device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # q's type differs from K's
        dec.flash_decode_cuda(q.float(), k, k, lens, bk=16)
    with pytest.raises(ValueError):
        dec.flash_decode_cuda(q.double(), k.double(), k.double(), lens, bk=16)
    with pytest.raises(ValueError):
        dec.flash_decode_cuda(q, k, k, lens, bk=5)
    with pytest.raises(ValueError):  # not a multiple of 8
        dec.flash_decode_cuda(q[..., :12], k[..., :12], k[..., :12], lens, bk=16)
    wide = torch.zeros((1, 16, 1, 264), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # past 256
        dec.flash_decode_cuda(wide[:, :1], wide, wide, lens, bk=16)
    with pytest.raises(ValueError):  # G past 16
        dec.flash_decode_cuda(torch.zeros((1, 1, 17, 64), dtype=torch.bfloat16, device=cuda),
                              k, k, lens, bk=16)
    big = torch.zeros((1, 256, 1, 256), device=cuda)
    with pytest.raises(ValueError):  # fp32, d 256, G 16, split 256: past 227 KB
        dec.flash_decode_cuda(torch.zeros((1, 1, 16, 256), device=cuda), big, big, lens,
                              bk=256)
    # what the reference takes runs: head_dim 32, fp32; int32 lengths need
    # no 16-byte alignment (a row of a stacked per-layer tensor)
    lens_view = torch.ones((2,), dtype=torch.int32, device=cuda)[1:]
    out = dec.flash_decode_cuda(q[..., :32].float(), k[..., :32].float(),
                                k[..., :32].float(), lens_view, bk=16)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def _decode_case(cuda, B, S, KV, G, d, bk, dtype, lengths, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, KV, G, d), (B, S, KV, d), (B, S, KV, d)))
    n_blk = S // bk
    tables = (torch.randperm(B * n_blk, generator=g, device=cuda) + 1).reshape(B, n_blk)
    tables = tables.to(torch.int32)
    kpool, vpool = (torch.randn((B * n_blk + 1, bk, KV, d), generator=g, device=cuda).to(dtype)
                    for _ in "kv")
    kpool[tables.long()] = k.reshape(B, n_blk, bk, KV, d)
    vpool[tables.long()] = v.reshape(B, n_blk, bk, KV, d)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, k, v, kpool, vpool, tables, lengths


def _assert_decode_matches_plain(got, want, dtype):
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= dec.FP32_TOL * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,d,S,bk", [
    (1, 16, 32, 8), (2, 16, 32, 8), (3, 16, 32, 8),       # tests/test_torch_decode_attention.py
    (2, 240, 256, 64), (16, 240, 128, 32),                # gemma3-12b's head_dim
    (3, 64, 256, 16), (10, 256, 512, 64), (4, 40, 96, 24),
])
def test_decode_kernels_at_every_head_dim_and_dtype(cuda, G, d, S, bk, dtype):
    """Kernel against the plain version (bf16 bitwise, fp32 within
    FP32_TOL of scale), paged == contiguous bitwise at bk == block_size in
    both types, with and without a window, through ``ops`` as well."""
    B, KV = 4, 2
    q, k, v, kpool, vpool, tables, lengths = _decode_case(
        cuda, B, S, KV, G, d, bk, dtype, [0, 7, S // 2 + 1, S], seed=G * d + S)
    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    again = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    torch.cuda.synchronize()
    assert contig.dtype == dtype and torch.equal(contig, paged) and torch.equal(contig, again)
    _assert_decode_matches_plain(contig, dec.decode_attention_plain(q, k, v, lengths, bk=bk),
                                 dtype)
    assert torch.equal(attn_ops.decode_attention(q, k, v, lengths, bk=bk), contig)
    for window in (None, 5):
        got = attn_ops.decode_attention_paged(q, kpool, vpool, tables, lengths, window=window)
        want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
        _assert_decode_matches_plain(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [(8, 960, 320), (3, 37, 70), (100, 960, 2560), (17, 64, 49)])
def test_gemm_kernel_matches_plain(cuda, M, K, N, trans_b):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = _randn((M, K), g, cuda)
    b = _randn((N, K) if trans_b else (K, N), g, cuda)
    got = matmul_cuda(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    want = matmul_plain(a, b, trans_b=trans_b)
    ulp = 2.0**-7 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_rows_do_not_depend_on_m(cuda, dtype):
    """Each output is summed in a fixed order that M does not change: a
    row's bits are the same whatever the other rows are (decode M and
    prefill M agree, across the M buckets)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a, b = (_randn(s, g, cuda).to(dtype) for s in ((40, 960), (960, 320)))
    full = matmul_cuda(a, b)
    assert full.dtype == dtype
    assert torch.equal(matmul_cuda(a[:8].contiguous(), b), full[:8])
    assert torch.equal(matmul_cuda(a[:16].contiguous(), b), full[:16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 384, 512), (64, 128, 256),
                                   (100, 130, 70)])
def test_gemm_reference_grid_through_ops(cuda, M, N, K, dtype):
    """``tests/test_kernels.py::test_matmul_shapes`` through ``ops.matmul``
    and ``ops.matmul_abft`` on CUDA tensors: fp32 within 1e-5 of the
    output's scale (full fp32, sums in other orders), bf16 within one ulp;
    the checksum GEMM's product bitwise the GEMM's, no flag."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    b = torch.randn((K, N), generator=g, device=cuda).to(dtype)
    for trans_b in (False, True):
        bb = b.T.contiguous() if trans_b else b
        got = mmops.matmul(a, bb, trans_b=trans_b)
        out, bad = mmops.matmul_abft(a, bb, trans_b=trans_b)
        torch.cuda.synchronize()
        want = matmul_plain(a, bb, trans_b=trans_b).float()
        rel = 1e-5 if dtype == torch.float32 else 2.0**-7
        assert got.dtype == dtype and torch.equal(out, got) and not bool(bad)
        assert float((got.float() - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M", [9, 17, 300])
@pytest.mark.parametrize("K,N", [(960, 320), (2560, 960), (64, 49)])
def test_gemm_abft_kernel(cuda, M, K, N, trans_b):
    """Product bitwise gemm_bf16's, both outputs the same bits on a second
    run, product and checksums against the plain version; M = 9 and 17 are
    the decode M (8 and 16 slots plus the checksum row), 300 a prefill M."""
    g = torch.Generator(device=cuda).manual_seed(M * 3 + K + N)
    a = _randn((M, K), g, cuda)
    b = _randn((N, K) if trans_b else (K, N), g, cuda)
    out, checks = matmul_abft_cuda(a, b, trans_b=trans_b)
    out2, checks2 = matmul_abft_cuda(a, b, trans_b=trans_b)
    base = matmul_cuda(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert torch.equal(out, base)
    assert torch.equal(out2, out) and torch.equal(checks2, checks)
    want, want_checks = matmul_abft_plain(a, b, trans_b=trans_b)
    ulp = 2.0**-7 * want.float().abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=ulp)
    bm = abft_block_rows(M)
    nrb = -(-M // bm)
    assert checks.shape == (nrb, N)
    a_abs = torch.nn.functional.pad(a.float().abs(), (0, 0, 0, nrb * bm - M))
    scale = a_abs.reshape(nrb, bm, K).sum(1) @ (b.T if trans_b else b).float().abs()
    assert bool(((checks - want_checks).abs() <= abft.ABFT_ATOL + abft.ABFT_RTOL * scale).all())
    assert not bool(mmops.matmul_abft(a, b, trans_b=trans_b)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_abft_rows_do_not_depend_on_m_across_the_tile_switch(cuda, dtype):
    """16 rows take the 16-row checksum block and M tile, 17 the 64-row block
    and the 32-row tile: a row's bits stay."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a, b = (_randn(s, g, cuda).to(dtype) for s in ((17, 960), (960, 2560)))
    o16, _ = matmul_abft_cuda(a[:16].contiguous(), b)
    o17, _ = matmul_abft_cuda(a, b)
    assert torch.equal(o16, o17[:16])
    assert torch.equal(matmul_cuda(a[:16].contiguous(), b), matmul_cuda(a, b)[:16])


GEMM_SERVE = [(960, 960, False), (960, 320, False), (960, 2560, False), (2560, 960, False),
              (960, 49152, True)]
GEMM_MS = [1, 8, 9, 16, 17, 40, 64, 65, 128, 129, 300, 2176]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("K,N", [(960, 320), (2560, 960), (960, 2560), (70, 130), (64, 49)])
def test_gemm_rows_do_not_depend_on_m_across_every_body(cuda, K, N, trans_b):
    """A row's bits at M = 1 ... 2176 equal its bits at 2176, through
    ``gemm`` and ``gemm_abft``, across the skinny/wide switch at 64 -> 65 and
    every M bucket; (70, 130) runs the masked path (140- and 260-byte rows),
    (64, 49) a single panel and a ragged N."""
    g = torch.Generator(device=cuda).manual_seed(K + N + trans_b)
    a = _randn((GEMM_MS[-1], K), g, cuda)
    b = _randn((N, K) if trans_b else (K, N), g, cuda)
    full = matmul_cuda(a, b, trans_b=trans_b)
    for M in GEMM_MS:
        part = a[:M].contiguous()
        got = matmul_cuda(part, b, trans_b=trans_b)
        out, _ = matmul_abft_cuda(part, b, trans_b=trans_b)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:M]), f"M={M}: rows differ from M=2176"
        assert torch.equal(out, got), f"M={M}: checksum GEMM's product differs"


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 2176])
@pytest.mark.parametrize("K,N,trans_b", GEMM_SERVE)
def test_gemm_serve_shapes(cuda, M, K, N, trans_b):
    """smollm-360m's projections at the decode M and a prefill M: within one
    bf16 ulp of the output's scale of the plain version, repeats bitwise,
    the checksum GEMM (M + 1 rows, as the ABFT path runs it) bitwise the
    GEMM's and its checksums within the ABFT tolerance."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = _randn((M + 1, K), g, cuda)
    b = _randn((N, K) if trans_b else (K, N), g, cuda)
    got = matmul_cuda(a[:M].contiguous(), b, trans_b=trans_b)
    again = matmul_cuda(a[:M].contiguous(), b, trans_b=trans_b)
    out, checks = matmul_abft_cuda(a, b, trans_b=trans_b)
    base = matmul_cuda(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    want = matmul_plain(a[:M], b, trans_b=trans_b).float()
    ulp = 2.0**-7 * float(want.abs().max())
    assert torch.equal(got, again) and torch.equal(out, base) and torch.equal(base[:M], got)
    assert float((got.float() - want).abs().max()) <= ulp
    _, want_checks = matmul_abft_plain(a, b, trans_b=trans_b)
    bm = abft_block_rows(M + 1)
    nrb = checks.shape[0]
    a_abs = torch.nn.functional.pad(a.float().abs(), (0, 0, 0, nrb * bm - M - 1))
    scale = a_abs.reshape(nrb, bm, K).sum(1) @ (b.T if trans_b else b).float().abs()
    assert bool(((checks - want_checks).abs() <= abft.ABFT_ATOL + abft.ABFT_RTOL * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M", [8, 300])
def test_gemm_misaligned_base_takes_the_masked_path(cuda, M, trans_b):
    """Operands whose base is 2 bytes past a 16-byte boundary (TMA refuses
    them) are loaded by the masked path into the same layout: the same bits
    as aligned copies of the same values."""
    K, N = 960, 320
    g = torch.Generator(device=cuda).manual_seed(M + trans_b)
    abuf = _randn((M * K + 1,), g, cuda)
    bbuf = _randn((N * K + 1,), g, cuda)
    a = abuf[1:].view(M, K)
    b = bbuf[1:].view(N, K) if trans_b else bbuf[1:].view(K, N)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    got = matmul_cuda(a, b, trans_b=trans_b)
    out, checks = matmul_abft_cuda(a, b, trans_b=trans_b)
    ref_out, ref_checks = matmul_abft_cuda(a.clone(), b.clone(), trans_b=trans_b)
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_cuda(a.clone(), b.clone(), trans_b=trans_b))
    assert torch.equal(out, got) and torch.equal(out, ref_out) and torch.equal(checks, ref_checks)
    want = matmul_plain(a, b, trans_b=trans_b).float()
    assert float((got.float() - want).abs().max()) <= 2.0**-7 * float(want.abs().max())


@pytest.mark.cuda
def test_gemm_plan_equals_the_kernels(cuda):
    """The Python plan (``matmul.plan``) equals the kernel's own
    (``gemm_plan``) at every M bucket of the serve shapes and at ragged
    and unaligned shapes."""
    from repro_torch.kernels.matmul import matmul as mm

    shapes = GEMM_SERVE + [(70, 130, False), (37, 49, True), (64, 49, False), (128, 64, True),
                           (0, 8, False), (12800, 100, False)]
    for M in GEMM_MS + [2177, 5000, 40000]:
        for K, N, trans_b in shapes:
            assert mm.kernel_plan(M, N, K, trans_b) == mm.plan(M, N, K, trans_b).as_ints(), \
                (M, K, N, trans_b)


@pytest.mark.cuda
def test_gemm_abft_calibration_on_the_card(cuda):
    """The calibrated tolerance on the kernel's own checksums: 200 clean
    products (decode and prefill M, the serve shapes' K) raise no flag, and
    a flip of a bf16-surviving bit (23..29) of a row's largest output of
    the kernel is caught by ``mm_check`` every time (as tests/test_sdc.py
    holds the reference)."""
    shapes = [(9, 960, 960), (17, 960, 2560), (9, 2560, 960), (130, 960, 320)]
    for i in range(200):
        M, K, N = shapes[i % len(shapes)]
        g = torch.Generator(device=cuda).manual_seed(10_000 + i)
        a, b = _randn((M, K), g, cuda), _randn((K, N), g, cuda) * 0.05
        assert not bool(mmops.matmul_abft(a, b)[1]), f"false positive at seed {10_000 + i}"
    for i in range(60):
        M, K, N = shapes[i % len(shapes)]
        g = torch.Generator(device=cuda).manual_seed(20_000 + i)
        a, b = _randn((M, K), g, cuda), _randn((K, N), g, cuda) * 0.05
        out = matmul_abft_cuda(a, b)[0]
        fault = np.array([abft.FAULT_MATMUL, 0, i % M, -1, 23 + i % 7, -1, 0, 0], np.int32)
        abft._maybe_flip(out, fault, abft.FAULT_MATMUL, 0, True)
        assert bool(abft.mm_check(a, b, out)), f"flip missed at seed {20_000 + i}"


@pytest.mark.cuda
@pytest.mark.parametrize("matmul", ["xla", "pallas"])
def test_engine_abft_tokens_equal_abft_off_on_the_card(cuda, matmul):
    cfg = get("smollm-360m-smoke")  # its own head_dim 16
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 37, 12, 60, 3)]
    outs = {}
    for mode in ("off", "checksum", "paranoid"):
        scfg = te.ServeConfig(
            max_len=128, scheduler=te.SchedulerConfig(batch=4, prefill_bucket=16),
            kv=te.KVConfig(layout="paged", block_size=16),
            kernel=te.KernelConfig(matmul=matmul, abft=mode),
        )
        matmul_abft_cuda.launches = 0
        eng = te.Engine(cfg, params, scfg)
        outs[mode] = [o.tolist() for o in eng.run(
            [te.Request(p, max_new=8, request_id=i) for i, p in enumerate(prompts)]
        )]
        assert eng.stats["sdc_detected"] == 0
        assert (matmul_abft_cuda.launches > 0) == (matmul == "pallas" and mode != "off")
    assert outs["checksum"] == outs["off"] == outs["paranoid"]


@pytest.mark.cuda
@pytest.mark.parametrize("matmul", ["xla", "pallas"])
def test_engine_on_the_card_paged_equals_contiguous(cuda, matmul):
    cfg = get("smollm-360m-smoke")  # its own head_dim 16
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab, 37).astype(np.int32)
    prompts = [pre, pre, np.concatenate([pre, [1, 2, 3]]), rng.integers(0, cfg.vocab, 9)]
    outs = {}
    for layout in ("contiguous", "paged"):
        kv = te.KVConfig(layout="paged", block_size=16) if layout == "paged" \
            else te.KVConfig(decode_block=16)
        scfg = te.ServeConfig(
            max_len=64, scheduler=te.SchedulerConfig(batch=4, prefill_bucket=16), kv=kv,
            kernel=te.KernelConfig(matmul=matmul),
        )
        for w in (dec.flash_decode_cuda, dec.flash_decode_paged_cuda, matmul_cuda):
            w.launches = 0
        eng = te.Engine(cfg, params, scfg)
        outs[layout] = [o.tolist() for o in eng.run(
            [te.Request(p, max_new=6, request_id=i) for i, p in enumerate(prompts)]
        )]
        kern = dec.flash_decode_paged_cuda if layout == "paged" else dec.flash_decode_cuda
        assert kern.launches > 0
        assert (matmul_cuda.launches > 0) == (matmul == "pallas")
    assert outs["paged"] == outs["contiguous"]


def _conv_tol(want):
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
    return ulp + 1e-3 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,K,FX,FY,tiles", [
    (2, 10, 12, 3, 5, 3, 3, None),                    # C = 3, K = 5: padded to 16
    (1, 30, 29, 64, 64, 1, 1, None),                  # 1x1
    (2, 17, 19, 40, 72, 5, 5, None),                  # 5x5, ragged C and K
    (1, 16, 20, 32, 48, 3, 1, None),                  # non-square filters
    (1, 20, 16, 32, 48, 1, 3, None),
    (1, 13, 11, 24, 40, 3, 2, (4, 5, 16, 64, 1, 2)),  # Ho, Wo not tile multiples
    (3, 9, 9, 96, 256, 3, 3, (7, 7, 16, 128, 2, 3)),  # two images a block, 3 stages
    (2, 12, 12, 200, 320, 1, 1, (5, 10, 64, 192, 1, 2)),  # 128-byte swizzle, 3 panels
    (2, 12, 12, 200, 320, 1, 1, (5, 10, 32, 256, 1, 2)),  # 64-byte swizzle, 4 panels
])
def test_conv2d_kernel_matches_plain(cuda, B, H, W, C, K, FX, FY, tiles):
    g = torch.Generator(device=cuda).manual_seed(B * H + C + K + FX * 7 + FY)
    x = _randn((B, H, W, C), g, cuda)
    w = _randn((FX, FY, C, K), g, cuda)
    t = cv.ConvTiles(*tiles) if tiles else convops.choose_conv_blocks(
        B, H - FX + 1, W - FY + 1, C, K, FX, FY)
    got = cv.conv2d_cuda(x, w, t)
    again = cv.conv2d_cuda(x, w, t)
    torch.cuda.synchronize()
    want = cv.conv2d_plain(x, w, t).float()
    assert got.shape == (B, H - FX + 1, W - FY + 1, K)
    assert bool(((got.float() - want).abs() <= _conv_tol(want)).all())
    assert torch.equal(got, again)  # one fixed order in one block: the same bits
    # the oracle (another route, fp32 throughout) agrees as well
    ref = cv.conv2d_plain(x.float(), w.float(), t)
    assert bool(((got.float() - ref).abs() <= _conv_tol(ref)).all())


@pytest.mark.cuda
def test_conv2d_ops_routes_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x, w = _randn((2, 15, 15, 16), g, cuda), _randn((3, 3, 16, 32), g, cuda)
    cv.conv2d_cuda.launches = 0
    got = convops.conv2d(x, w)
    assert cv.conv2d_cuda.launches == 1
    strided = convops.conv2d(x, w, stride=2)  # the plain oracle, as the reference routes it
    assert cv.conv2d_cuda.launches == 1 and strided.shape == (2, 7, 7, 32)
    want = cv.conv2d_plain(x, w, convops.choose_conv_blocks(2, 13, 13, 16, 32, 3, 3)).float()
    assert bool(((got.float() - want).abs() <= _conv_tol(want)).all())
    with pytest.raises(ValueError):
        convops.conv2d(x.double(), w.double())  # the kernel takes bf16 and fp32 only
    cv.conv2d_cuda.launches = 0
    got32 = convops.conv2d(x.float(), w.float())  # fp32 runs the kernel too
    assert cv.conv2d_cuda.launches == 1 and got32.dtype == torch.float32
    tiles32 = convops.choose_conv_blocks(2, 13, 13, 16, 32, 3, 3, word_bytes=4)
    want32 = cv.conv2d_plain(x.float(), w.float(), tiles32)
    assert float((got32 - want32).abs().max()) <= 1e-5 * float(want32.abs().max())


def _conv32_tol(want):
    return 1e-5 * want.abs() + 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,C,K,F", [(1, 8, 8, 16, 3), (2, 13, 16, 8, 3), (1, 6, 4, 4, 1),
                                       (2, 10, 3, 5, 5)])
def test_conv2d_reference_grid_through_ops(cuda, B, H, C, K, F, dtype):
    """``tests/test_kernels.py::test_conv2d_shapes`` through ``ops.conv2d``
    on CUDA tensors, against the plain version on the same tile: fp32
    within 1e-5 of the element plus 1e-5 of the scale (full fp32 on the
    CUDA cores, sums in other orders), bf16 within one ulp plus 1e-3."""
    g = torch.Generator(device=cuda).manual_seed(B * H + C + K + F)
    x = torch.randn((B, H, H, C), generator=g, device=cuda).to(dtype)
    w = torch.randn((F, F, C, K), generator=g, device=cuda).to(dtype)
    cv.conv2d_cuda.launches = 0
    got = convops.conv2d(x, w)
    again = convops.conv2d(x, w)
    torch.cuda.synchronize()
    assert cv.conv2d_cuda.launches == 2 and torch.equal(got, again)
    t = convops.choose_conv_blocks(B, H - F + 1, H - F + 1, C, K, F, F,
                                   word_bytes=x.element_size())
    want = cv.conv2d_plain(x, w, t).float()
    tol = _conv32_tol(want) if dtype == torch.float32 else _conv_tol(want)
    assert got.dtype == dtype and bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,F,X", [(64, 64, 3, 56), (256, 384, 3, 13), (480, 192, 1, 14),
                                     (16, 32, 5, 27)])
def test_conv2d_fp32_tiles_fit_and_match_plain(cuda, C, K, F, X):
    """The search's fp32 tiles, fitted in 4-byte words, all launch (none
    is refused for its shared memory) and match the plain version."""
    t = convops.choose_conv_blocks(2, X, X, C, K, F, F, word_bytes=4)
    assert t.smem_bytes(F, F, 4) <= hw.SMEM_BUDGET_BYTES
    g = torch.Generator(device=cuda).manual_seed(C + K + F)
    x = torch.randn((2, X + F - 1, X + F - 1, C), generator=g, device=cuda)
    w = torch.randn((F, F, C, K), generator=g, device=cuda) * 0.1
    got = cv.conv2d_cuda(x, w, t)
    torch.cuda.synchronize()
    want = cv.conv2d_plain(x, w, t)
    assert bool(((got - want).abs() <= _conv32_tol(want)).all())


@pytest.mark.cuda
def test_conv2d_refused_launch_raises(cuda):
    """A tile whose ring is past the 227 KB a block may have is refused at
    launch: the wrapper raises instead of returning garbage; a tile the
    kernel cannot take at all (more pixels than the block's 128 rows, or
    more accumulator and A registers than a thread has) raises before the
    launch."""
    x = torch.zeros((1, 40, 40, 512), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((5, 5, 512, 256), dtype=torch.bfloat16, device=cuda)
    t = cv.ConvTiles(8, 8, 32, 256, 1, 2)
    assert t.ring_bytes(5, 5) > hw.SMEM_PER_BLOCK_BYTES
    with pytest.raises(RuntimeError):
        cv.conv2d_cuda(x, w, t)
    with pytest.raises(ValueError):  # more pixels than the block's rows
        cv.conv2d_cuda(x, w, cv.ConvTiles(16, 17, 16, 64, 1, 2))
    big = cv.ConvTiles(4, 4, 64, 256, 1, 2)  # 128 accumulators + 16 A registers
    assert big.data_regs() > cv.TC_DATA_REGS
    with pytest.raises(ValueError):
        cv.conv2d_cuda(x, w[:1, :1].contiguous(), big)


def _paper_shapes():
    from repro_torch.core import networks
    out = {}
    for net in ("alexnet", "vgg16", "googlenet"):
        for n in getattr(networks, net)(16):
            b = n.bounds
            if b["X"] > 1 and n.tensor("I").coupled["X"][1] == 1:
                out.setdefault((b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"]),
                               f"{net}/{n.name}")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(_paper_shapes()), ids=list(_paper_shapes().values()))
def test_conv2d_paper_shapes_at_batch_2(cuda, shape):
    """Each distinct stride-1 CONV layer of the paper's CNNs at batch 2,
    through ``ops.conv2d`` on the tile the search picks for it: one launch
    a call, within one bf16 ulp + 1e-3 of scale of the plain version, a
    repeat bitwise equal."""
    X, Y, C, K, FX, FY = shape
    g = torch.Generator(device=cuda).manual_seed(X + C + K)
    x = _randn((2, X + FX - 1, Y + FY - 1, C), g, cuda)
    w = _randn((FX, FY, C, K), g, cuda)
    cv.conv2d_cuda.launches = 0
    got = convops.conv2d(x, w)
    assert cv.conv2d_cuda.launches == 1
    again = convops.conv2d(x, w)
    torch.cuda.synchronize()
    assert cv.conv2d_cuda.launches == 2 and torch.equal(got, again)
    want = cv.conv2d_plain(x, w, convops.choose_conv_blocks(2, X, Y, C, K, FX, FY)).float()
    assert bool(((got.float() - want).abs() <= _conv_tol(want)).all())


@pytest.mark.cuda
def test_conv2d_refuses_misaligned_operands(cuda):
    """TMA reads 16-byte aligned tensors: a bf16 operand whose data starts
    2 bytes into its storage is refused, never sent to the plain version."""
    n = 2 * 9 * 9 * 16
    base = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    x = base[1: n + 1].view(2, 9, 9, 16)
    w = torch.zeros((3, 3, 16, 64), dtype=torch.bfloat16, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16
    t = convops.choose_conv_blocks(2, 7, 7, 16, 64, 3, 3)
    cv.conv2d_cuda.launches = 0
    with pytest.raises(ValueError):
        cv.conv2d_cuda(x, w, t)
    wb = torch.zeros(3 * 3 * 16 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        cv.conv2d_cuda(x.clone(), wb[1: 3 * 3 * 16 * 64 + 1].view(3, 3, 16, 64), t)
    assert cv.conv2d_cuda.launches == 0


def _wkv_inputs(B, H, T, gen, dev, bthd=False):
    """Seeded fp32 streams with a decay w in (0, 1) that varies per step
    and channel; with ``bthd`` the streams are (B, H, T, 64) views of
    (B, T, H, 64) storage, as the model passes them."""
    shape = (B, T, H, 64) if bthd else (B, H, T, 64)

    def stream():
        t = torch.randn(shape, generator=gen, device=dev)
        return t.transpose(1, 2) if bthd else t

    r, k, v = stream(), stream(), stream()
    w = torch.exp(-torch.exp(stream() - 1.0))
    u = 0.5 * torch.randn((H, 64), generator=gen, device=dev)
    s0 = torch.randn((B, H, 64, 64), generator=gen, device=dev)
    return r, k, v, w, u, s0


def _assert_wkv_close(got, want):
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert float((g_ - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bthd", [False, True])
@pytest.mark.parametrize("B,H,T", [(8, 32, 1), (1, 32, 256), (3, 2, 37), (2, 1, 0)])
def test_wkv6_kernel_matches_plain(cuda, B, H, T, bthd):
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + H + T)
    args = _wkv_inputs(B, H, T, g, cuda, bthd)
    got = wkv6_cuda(*args)
    again = wkv6_cuda(*args)
    torch.cuda.synchronize()
    if T > 1:
        assert got[0].stride() == args[0].stride()  # out comes back in r's layout
    if T:
        _assert_wkv_close(got, wkv6_plain(*args))
    else:
        assert torch.equal(got[1], args[5])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_wkv6_updates_the_state_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    r, k, v, w, u, s0 = _wkv_inputs(4, 3, 9, g, cuda, bthd=True)
    want = wkv6_cuda(r, k, v, w, u, s0)
    state = s0.clone()
    out, sT = wkv6_cuda(r, k, v, w, u, state, inplace=True)
    torch.cuda.synchronize()
    assert sT.data_ptr() == state.data_ptr()
    assert torch.equal(out, want[0]) and torch.equal(state, want[1])


@pytest.mark.cuda
def test_wkv6_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    r, k, v, w, u, s0 = _wkv_inputs(1, 2, 5, g, cuda)
    with pytest.raises(ValueError):  # fp32 only
        wkv6_cuda(r.bfloat16(), k.bfloat16(), v.bfloat16(), w.bfloat16(), u, s0)
    with pytest.raises(ValueError):
        wkv6_cuda(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError):  # head sizes 16, 32 and 64 only
        wkv6_cuda(r[..., :48], k[..., :48], v[..., :48], w[..., :48], u[:, :48].contiguous(),
                  s0[..., :48, :48].contiguous())
    with pytest.raises(ValueError):
        wkv6_cuda(r, k, v[..., :8], w, u, s0[..., :8].contiguous())
    with pytest.raises(ValueError):  # s0 must be (B, H, Dk, Dv)
        wkv6_cuda(r, k, v[..., :32], w, u, s0[..., :32, :].contiguous())
    # what the reference takes runs: Dk 32 with Dv 64
    out, sT = wkv6_cuda(r[..., :32], k[..., :32], v, w[..., :32], u[:, :32].contiguous(),
                        s0[..., :32, :].contiguous())
    assert out.shape == v.shape and sT.shape == (1, 2, 32, 64)
    with pytest.raises(ValueError):  # one layout for r, k and w
        wkv6_cuda(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, w, u, s0)
    # v has strides of its own (its head size may differ from r's): another
    # dense layout runs, and its output comes back in it
    v_t = v.transpose(1, 2).contiguous().transpose(1, 2)
    out, sT = wkv6_cuda(r, k, v_t, w, u, s0)
    assert out.stride() == v_t.stride()
    _assert_wkv_close((out, sT), wkv6_plain(r, k, v, w, u, s0))
    with pytest.raises(ValueError):
        wkv6_cuda(r, k, v, w, u, s0.transpose(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("T,Dk,Dv", [(8, 16, 16), (32, 64, 64), (17, 32, 64), (9, 64, 16),
                                     (5, 16, 32)])
def test_wkv6_reference_grid_through_ops(cuda, T, Dk, Dv):
    """``tests/test_kernels.py::test_wkv6_kernel``'s (T, Dk, Dv) and more
    pairs apart through ``ops.wkv6`` on CUDA tensors, (B, H, T, D) views of
    (B, T, H, D) storage, against the plain version within 1e-5 of scale."""
    B, H = 2, 3
    g = torch.Generator(device=cuda).manual_seed(T * 100 + Dk + Dv)

    def stream(D):
        return torch.randn((B, T, H, D), generator=g, device=cuda).transpose(1, 2)

    r, k, v = stream(Dk), stream(Dk), stream(Dv)
    w = torch.sigmoid(stream(Dk))
    u = torch.randn((H, Dk), generator=g, device=cuda)
    s0 = torch.randn((B, H, Dk, Dv), generator=g, device=cuda)
    wkv6_cuda.launches = 0
    got = ls_ops.wkv6(r, k, v, w, u, s0)
    again = ls_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6_cuda.launches == 2
    assert got[0].shape == (B, H, T, Dv) and got[0].stride() == v.stride()
    _assert_wkv_close(got, wkv6_plain(r, k, v, w, u, s0))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_wkv6_launches_once_per_layer_decode_then_prefill(cuda):
    cfg = get("rwkv6-1.6b-smoke")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    caches = model.init_caches(2, 32, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 7), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    wkv6_cuda.launches = 0
    logits, _ = model.decode_step(params, toks[:, :1], caches)
    assert wkv6_cuda.launches == cfg.n_layers
    model.prefill(params, toks, caches)
    assert wkv6_cuda.launches == 2 * cfg.n_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("matmul", ["xla", "pallas"])
def test_rwkv_engine_on_the_card_batched_equals_solo(cuda, matmul):
    cfg = get("rwkv6-1.6b-smoke")
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(4)
    reqs = [te.Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate([(6, 5), (9, 7), (4, 4), (13, 6)])]
    scfg = te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=2),
                          kernel=te.KernelConfig(matmul=matmul))
    wkv6_cuda.launches = 0
    outs = te.Engine(cfg, params, scfg).run(reqs)
    assert wkv6_cuda.launches > 0
    assert [o.status for o in outs] == [te.RequestStatus.FINISHED] * 4
    solo = te.Engine(cfg, params, scfg).run([reqs[1]])[0]
    assert np.array_equal(solo, outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("G,d,S,bk", [(10, 256, 2048, 64), (10, 256, 256, 128), (16, 128, 256, 16)])
def test_decode_kernels_at_head_dim_256_and_wide_groups(cuda, G, d, S, bk):
    """recurrentgemma-2b's decode shape (8 rows, 1 KV head of 10 query
    heads, head_dim 256, a 2048-slot ring, bk 64): kernel == plain bitwise,
    paged == contiguous at bk == block_size; most rows wrapped (length S)."""
    B, KV = 8, 1
    g = torch.Generator(device=cuda).manual_seed(G * d + S)
    q, k, v = (_randn(s, g, cuda) for s in ((B, KV, G, d), (B, S, KV, d), (B, S, KV, d)))
    n_blk = S // bk
    tables = (torch.randperm(B * n_blk, generator=g, device=cuda) + 1).reshape(B, n_blk)
    tables = tables.to(torch.int32)
    kpool, vpool = (_randn((B * n_blk + 1, bk, KV, d), g, cuda) for _ in "kv")
    kpool[tables.long()] = k.reshape(B, n_blk, bk, KV, d)
    vpool[tables.long()] = v.reshape(B, n_blk, bk, KV, d)
    lengths = torch.tensor([1, 17, S // 2 + 3, S - 1, S, S, S, S], dtype=torch.int32,
                           device=cuda)
    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    torch.cuda.synchronize()
    assert torch.equal(contig, paged)
    assert torch.equal(contig, dec.decode_attention_plain(q, k, v, lengths, bk=bk))
    assert torch.equal(paged, dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths))
    assert bool(torch.isfinite(contig.float()).all())


def _split_lengths(n, bk):
    """Rows that end in different blocks of the cluster (min(8, n) blocks
    over n splits), a length of 0 and one of every slot among them."""
    S = n * bk
    return [0, 1, bk, bk + 1, (n // 2) * bk + 3, (3 * n // 4) * bk, S - 1, S]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,G,d,bk", [(1, 10, 256, 64), (7, 3, 64, 16), (9, 10, 256, 64),
                                      (33, 16, 128, 8), (256, 3, 64, 16)])
def test_split_decode_at_every_split_count(cuda, n, G, d, bk, dtype):
    """The cluster-split kernel at split counts 1, 7, 9, 33 and 256 (one
    block; a cluster of 7; counts that do not divide the cluster of 8;
    rows with fewer live splits than blocks, and rows ending in each
    block): kernel == plain (bf16 bitwise, fp32 within FP32_TOL of scale),
    paged == contiguous bitwise, with and without a window that masks
    whole leading splits, two calls bitwise equal, one launch per call."""
    B, KV = 8, 1
    q, k, v, kpool, vpool, tables, lengths = _decode_case(
        cuda, B, n * bk, KV, G, d, bk, dtype, _split_lengths(n, bk), seed=n * 31 + d)
    c0, p0 = dec.flash_decode_cuda.launches, dec.flash_decode_paged_cuda.launches
    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    assert dec.flash_decode_cuda.launches == c0 + 1
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    assert dec.flash_decode_paged_cuda.launches == p0 + 1
    again = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    torch.cuda.synchronize()
    assert torch.equal(contig, paged) and torch.equal(contig, again)
    _assert_decode_matches_plain(contig, dec.decode_attention_plain(q, k, v, lengths, bk=bk),
                                 dtype)
    for window in (None, 1, bk + 3, 3 * bk):
        got = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=window)
        want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
        _assert_decode_matches_plain(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_decode_rows_alone_equal_rows_in_the_batch(cuda, dtype):
    """A row's output does not depend on the other rows of the batch: the
    plan follows the shape alone and each (row, kv head) has its own
    cluster, so decode attention stays row- and length-invariant."""
    n, G, d, bk = 32, 10, 256, 64
    q, k, v, kpool, vpool, tables, lengths = _decode_case(
        cuda, 8, n * bk, 1, G, d, bk, dtype, [37, 1500] + [n * bk] * 6, seed=5)
    batch = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=700)
    for b in range(8):
        s = slice(b, b + 1)
        assert torch.equal(dec.flash_decode_cuda(q[s], k[s], v[s], lengths[s], bk=bk), batch[s])
        assert torch.equal(
            dec.flash_decode_paged_cuda(q[s], kpool, vpool, tables[s], lengths[s], window=700),
            paged[s])


@pytest.mark.cuda
def test_split_decode_never_synchronizes_the_host(cuda):
    """The grid is sized from the host-known split count: neither wrapper
    reads ``lengths`` (or anything else) back to the host."""
    q, k, v, kpool, vpool, tables, lengths = _decode_case(
        cuda, 8, 2048, 1, 10, 256, 64, torch.bfloat16, [37, 1500] + [2048] * 6, seed=9)
    dec.flash_decode_cuda(q, k, v, lengths, bk=64)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = dec.flash_decode_cuda(q, k, v, lengths, bk=64)
        b = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
        c = attn_ops.decode_attention_paged(q, kpool, vpool, tables, lengths, window=100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(c.float()).all())


def _scan_inputs(B, T, D, gen, dev):
    a = torch.rand((B, T, D), generator=gen, device=dev)
    x = torch.randn((B, T, D), generator=gen, device=dev)
    h0 = torch.randn((B, D), generator=gen, device=dev)
    return a, x, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(8, 1, 2560), (1, 2048, 2560), (3, 37, 100), (2, 0, 64),
                                   (1, 5, 1)])
def test_linear_scan_kernel_equals_plain_bitwise(cuda, B, T, D):
    g = torch.Generator(device=cuda).manual_seed(B * 7 + T + D)
    a, x, h0 = _scan_inputs(B, T, D, g, cuda)
    got = linear_scan_cuda(a, x, h0)
    again = linear_scan_cuda(a, x, h0)
    want = linear_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_linear_scan_strided_views_and_in_place_state(cuda):
    """a and x as (B, T, D) views with row and step strides (the channel
    axis contiguous); the state of a stacked cache updated in place."""
    g = torch.Generator(device=cuda).manual_seed(21)
    a, x, h0 = _scan_inputs(3, 40, 96, g, cuda)
    wide_a = torch.rand((3, 80, 96), generator=g, device=cuda)
    wide_a[:, ::2] = a
    wide_x = torch.randn((3, 40, 200), generator=g, device=cuda)
    wide_x[..., 50:146] = x
    stack = torch.randn((2, 3, 96), generator=g, device=cuda)
    stack[1] = h0
    want = linear_scan_plain(a, x, h0)
    out, hT = linear_scan_cuda(wide_a[:, ::2], wide_x[..., 50:146], stack[1], inplace=True)
    torch.cuda.synchronize()
    assert hT.data_ptr() == stack[1].data_ptr()
    assert torch.equal(out, want[0]) and torch.equal(stack[1], want[1])


@pytest.mark.cuda
def test_linear_scan_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(22)
    a, x, h0 = _scan_inputs(2, 5, 64, g, cuda)
    with pytest.raises(ValueError):  # fp32 only
        linear_scan_cuda(a.bfloat16(), x.bfloat16(), h0.bfloat16())
    with pytest.raises(ValueError):
        linear_scan_cuda(a, x, h0.double())
    with pytest.raises(ValueError):  # channel axis contiguous
        linear_scan_cuda(a.transpose(1, 2).contiguous().transpose(1, 2), x, h0)
    with pytest.raises(ValueError):
        linear_scan_cuda(a, x, h0[:1])
    with pytest.raises(ValueError):  # no CPU operand beside a CUDA one
        linear_scan_cuda(a, x, h0.cpu())


@pytest.mark.cuda
def test_hybrid_launch_counts_and_engine_batched_equals_solo(cuda):
    """recurrentgemma-2b-smoke at its own head_dim 16, on the card: one
    scan launch per rnn layer per prefill and decode call, one
    decode-attention launch per attention layer per decode step under
    ``attention="flash"``; batched output == solo output through the
    engine."""
    cfg = get("recurrentgemma-2b-smoke")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    caches = model.init_caches(2, 32, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    linear_scan_cuda.launches = dec.flash_decode_cuda.launches = 0
    model.prefill(params, toks, caches)
    logits, _ = model.decode_step(params, toks[:, :1], caches,
                                  dispatch=Dispatch(attention="flash"))
    assert linear_scan_cuda.launches == 2 * 3
    assert dec.flash_decode_cuda.launches == 1
    assert bool(torch.isfinite(logits).all())
    rng = np.random.default_rng(4)
    reqs = [te.Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate([(6, 5), (9, 7), (4, 4), (13, 6)])]
    scfg = te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=2))
    outs = te.Engine(cfg, params, scfg).run(reqs)
    assert [o.status for o in outs] == [te.RequestStatus.FINISHED] * 4
    solo = te.Engine(cfg, params, scfg).run([reqs[1]])[0]
    assert np.array_equal(solo, outs[1])


# ---------------------------------------------------------- flash attention


def _flash_inputs(cuda, B, Tq, Tk, KV, G, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, Tq, KV, G, d), (B, Tk, KV, d), (B, Tk, KV, d)))


def _flash_check(q, k, v, **kw):
    """The kernel through ``ops.flash_attention`` (twice: repeat runs
    bitwise, one launch each) against the plain version on the same
    inputs, each (b, t, head) row held to its own norm: ||got - want||
    within 1e-5 of ||want|| in fp32, 1e-2 in bf16.  One scale for the
    whole tensor would be set by the early rows, which see few keys, and
    hide a dropped or misplaced key tile in the late ones."""
    fa.flash_attention_cuda.launches = 0
    got = attn_ops.flash_attention(q, k, v, **kw)
    again = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == 2
    want = attn_ops.flash_attention(q, k, v, impl="plain", **kw).float()
    rel = 1e-5 if q.dtype == torch.float32 else 1e-2
    assert got.shape == q.shape and got.dtype == q.dtype and torch.equal(got, again)
    err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(err.max()) <= rel, float(err.max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,Tk,window", [
    (128, 128, None), (256, 256, None), (128, 128, 32), (64, 192, None),
])
def test_flash_attention_kernel_reference_grid(cuda, Tq, Tk, window, dtype):
    """``tests/test_kernels.py``'s flash-attention cases (bq = bk = 64) and
    its cached decode (offset 100, kv_len 108)."""
    _flash_check(*_flash_inputs(cuda, 2, Tq, Tk, 2, 2, 32, dtype, Tq + Tk),
                 window=window, bq=64, bk=64)
    _flash_check(*_flash_inputs(cuda, 1, 8, 128, 1, 2, 32, dtype, 5),
                 q_offset=100, kv_len=108, bq=8, bk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,d", [(1, 16), (3, 16), (2, 24), (1, 240), (3, 256), (2, 136)])
def test_flash_attention_kernel_groups_head_dims_and_variants(cuda, G, d, dtype):
    """Head dims that are multiples of 8 but not 16, ragged tiles, both
    variants, a non-causal window, a chunk over a longer cache."""
    q, k, v = _flash_inputs(cuda, 2, 70, 90, 2, G, d, dtype, G * d)
    _flash_check(q, k, v)
    _flash_check(q, k, v, q_offset=20, kv_len=85)
    _flash_check(q, k, v, causal=False, window=12, bk=32)
    _flash_check(q, k, v, window=30, q_offset=15, kv_len=200, bk=24)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_rows_with_no_live_key(cuda, dtype):
    """A query with no live key is the mean of the V rows the reference
    visits: static, 64 queries over 40 keys, window 16, bk 32 (64 visited,
    24 of them padding); dynamic, offset 100, kv_len 40, window 16, bk 16
    (keys [0, 48) visited)."""
    q, k, v = _flash_inputs(cuda, 1, 64, 40, 1, 2, 16, dtype, 11)
    got = _flash_check(q, k, v, window=16, bk=32)
    mean = v[0, :, 0].float().sum(0) / 64
    assert float((got[0, 55:].float() - mean).abs().max()) <= 1e-2 * float(mean.abs().max())
    q, k, v = _flash_inputs(cuda, 1, 8, 64, 1, 2, 16, dtype, 12)
    got = _flash_check(q, k, v, window=16, q_offset=100, kv_len=40, bk=16)
    mean = v[0, :48, 0].float().mean(0)
    assert float((got[0].float() - mean).abs().max()) <= 1e-2 * float(mean.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smollm", "recurrentgemma", "gemma3", "smollm_chunk"])
def test_flash_attention_kernel_full_width_shapes(cuda, case):
    """The served models' prefill shapes at one layer, bf16: smollm-360m
    (8 x 1024 tokens, 15 heads on 5, d 64), recurrentgemma-2b's attention
    layer (2048 tokens, 10 heads on 1, d 256, window 2048), gemma3-12b's
    local layer (4096 tokens, 16 heads on 8, d 240, window 1024), and a
    smollm chunk of 256 queries at offset 768 over 1024 keys."""
    B, Tq, Tk, KV, G, d, kw = {
        "smollm": (8, 1024, 1024, 5, 3, 64, {}),
        "recurrentgemma": (1, 2048, 2048, 1, 10, 256, dict(window=2048)),
        "gemma3": (1, 4096, 4096, 8, 2, 240, dict(window=1024)),
        "smollm_chunk": (8, 256, 1024, 5, 3, 64, dict(q_offset=768, kv_len=1024)),
    }[case]
    q, k, v = _flash_inputs(cuda, B, Tq, Tk, KV, G, d, torch.bfloat16, 21)
    got = _flash_check(q, k, v, **kw)
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 16, 16, 1, 2, 64, torch.bfloat16, 1)
    with pytest.raises(ValueError):  # mixed types
        attn_ops.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError):  # bf16 and fp32 only
        attn_ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):  # head_dim a multiple of 8
        attn_ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    wide = torch.zeros((1, 16, 1, 264), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # up to 256
        attn_ops.flash_attention(wide[:, :, :, None].expand(1, 16, 1, 2, 264), wide, wide)
    with pytest.raises(ValueError):  # no CPU operand beside CUDA ones
        attn_ops.flash_attention(q, k.cpu(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 16])
@pytest.mark.parametrize("d", [16, 40, 64, 128, 240, 256])
def test_flash_attention_tma_body_edges(cuda, d, G):
    """The bf16 body at each panel count of its plan: 200 queries (no
    multiple of the 128-query tile) over 333 keys (no multiple of the
    64- or 128-key tile), static and dynamic, causal and not, a window of
    20 (narrower than a key tile) and a chunk whose rows have no live key
    (each the mean of the 333 visited V rows)."""
    KV = 2 if G == 1 else 1
    q, k, v = _flash_inputs(cuda, 2, 200, 333, KV, G, d, torch.bfloat16, d + G)
    _flash_check(q, k, v)
    _flash_check(q, k, v, causal=False)
    _flash_check(q, k, v, q_offset=133, kv_len=300, bk=48)
    _flash_check(q, k, v, window=20, bk=32)
    got = _flash_check(q, k, v, causal=False, window=5, q_offset=400, kv_len=333)
    mean = v.float().mean(1)[:, None, :, None, :]
    assert float((got.float() - mean).abs().max()) <= 1e-2 * float(mean.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_tma_body_reads_any_strides(cuda, d):
    """Tensor maps follow the views' strides: q and out-of-place k in
    (B, H, T, d) order, v a slice of wider rows, k broadcast over the
    batch (stride 0), each against the plain version on the same views."""
    B, Hq, KV, Tq, Tk = 2, 6, 3, 150, 260
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((B, Hq, Tq, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, KV, Tk, d), generator=g, device=cuda).bfloat16().expand(B, KV, Tk, d)
    wide = torch.randn((B, Tk, KV, d + 64), generator=g, device=cuda).bfloat16()
    v = wide[..., 16:16 + d].transpose(1, 2)
    for kw in (dict(bk=64), dict(bk=32, window=40, q_offset=110, kv_len=250)):
        fa.flash_attention_cuda.launches = 0
        got = fa.flash_attention_cuda(q, k, v, **kw)
        again = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        assert fa.flash_attention_cuda.launches == 2 and torch.equal(got, again)
        err = (got.float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        assert float(err.max()) <= 1e-2, float(err.max())


@pytest.mark.cuda
def test_flash_attention_plan_matches_the_kernel(cuda):
    """``flash_attention.plan`` is the kernel's own plan for every head_dim."""
    lib = _build.library("flash_attention", fa._SIGS)
    out = (ctypes.c_int * 4)()
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        assert lib.flash_plan(d, ctypes.addressof(out)) == 0
        assert tuple(out) == dataclasses.astuple(fa.plan(d)), d
    assert lib.flash_plan(12, ctypes.addressof(out)) != 0


# ------------------------------------------- the recurrences' Hopper bodies


def _scan_check(a, x, h0, body=None):
    """The scan kernel bitwise its plain version and its own repeat, in
    the body its plan names (``body``, where given), which the kernel's
    own plan confirms."""
    got = linear_scan_cuda(a, x, h0)
    again = linear_scan_cuda(a, x, h0)
    want = linear_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    plan = ls_mod.scan_plan(*a.shape, *ls_mod.scan_eligibility(a, x, h0, *got))
    assert ls_mod.scan_kernel_plan(a, x, h0, *got) == plan.as_ints()
    if body is not None:
        assert plan.body == body


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D", [(8, 8, 2560), (8, 9, 2560), (2, 63, 100), (2, 65, 100),
                                   (3, 64, 100), (2, 129, 100), (1, 2053, 2560), (5, 170, 96),
                                   (2, 70, 12), (2, 40, 1), (2, 3, 1)])
def test_linear_scan_bodies_equal_plain_bitwise(cuda, B, T, D):
    """T on both sides of the step body's threshold (8), of the ring's
    switch from one 64-step stage to 128-step stages (64 / 65) and of a
    128-step stage, mostly no multiple of a stage; D not a multiple of the
    ring's 32-channel tile (or below it) nor of the step body's 4-channel
    vector; D = 1."""
    g = torch.Generator(device=cuda).manual_seed(B * 31 + T * 7 + D)
    a, x, h0 = _scan_inputs(B, T, D, g, cuda)
    expect = ("step4" if D % 4 == 0 else "step1") if T <= ls_mod.SCAN_STEP_MAX_T else (
        "ring_tma" if D % 4 == 0 else "ring_copy")
    _scan_check(a, x, h0, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 40, 300])
def test_linear_scan_misaligned_bases_take_their_own_paths(cuda, T):
    """Bases 4 bytes past a 16-byte boundary and step strides that are no
    multiple of 16 bytes: the step body's 4-byte loads, the ring's 4-byte
    cp.async; each bitwise."""
    g = torch.Generator(device=cuda).manual_seed(T)
    B, D = 3, 96
    wide = torch.randn((B, T, D + 5), generator=g, device=cuda)
    a = torch.rand((B, T, D + 5), generator=g, device=cuda)[..., 1:1 + D]
    x = wide[..., 3:3 + D]
    h0 = torch.randn((B, D + 1), generator=g, device=cuda)[:, 1:]
    _scan_check(a, x, h0, "step1" if T <= ls_mod.SCAN_STEP_MAX_T else "ring_copy")


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0.0, 1.0])
@pytest.mark.parametrize("T", [1, 77])
def test_linear_scan_at_decays_zero_and_one(cuda, fill, T):
    g = torch.Generator(device=cuda).manual_seed(int(fill) * 10 + T)
    _, x, h0 = _scan_inputs(4, T, 2560, g, cuda)
    a = torch.full_like(x, fill)
    _scan_check(a, x, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 200])
def test_linear_scan_in_place_through_every_body(cuda, T):
    g = torch.Generator(device=cuda).manual_seed(40 + T)
    a, x, h0 = _scan_inputs(2, T, 2560, g, cuda)
    want = linear_scan_cuda(a, x, h0)
    state = h0.clone()
    out, hT = linear_scan_cuda(a, x, state, inplace=True)
    torch.cuda.synchronize()
    assert hT.data_ptr() == state.data_ptr()
    assert torch.equal(out, want[0]) and torch.equal(state, want[1])


def _wkv_pair_inputs(B, H, T, Dk, Dv, gen, dev, w=None):
    """(B, H, T, D) views of (B, T, H, D) streams with key and value head
    sizes apart; a decay w in (0, 1) per step and channel unless given."""
    def stream(D):
        return torch.randn((B, T, H, D), generator=gen, device=dev).transpose(1, 2)

    r, k, v = stream(Dk), stream(Dk), stream(Dv)
    w = torch.exp(-torch.exp(stream(Dk) - 1.0)) if w is None else torch.full_like(r, w)
    u = 0.5 * torch.randn((H, Dk), generator=gen, device=dev)
    s0 = torch.randn((B, H, Dk, Dv), generator=gen, device=dev)
    return r, k, v, w, u, s0


def _wkv_check(args):
    r, k, v, w, u, s0 = args
    got = wkv6_cuda(*args)
    again = wkv6_cuda(*args)
    torch.cuda.synchronize()
    _assert_wkv_close(got, wkv6_plain(*args))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    plan = ls_mod.wkv_plan(*r.shape, v.shape[3], ls_mod.wkv_vec_ok(r, k, v, w, s0, *got))
    assert ls_mod.wkv_kernel_plan(r, k, v, w, s0, *got) == plan.as_ints()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 40])
def test_wkv6_row_alone_equals_the_row_in_a_batch(cuda, T):
    """A row of a B = 8, H = 32 call, bitwise the same row called alone:
    the order of every sum is fixed by Dk alone, not by B, H or the grid."""
    g = torch.Generator(device=cuda).manual_seed(70 + T)
    args = _wkv_pair_inputs(8, 32, T, 64, 64, g, cuda)
    got = _wkv_check(args)
    for b, h in ((0, 0), (5, 17), (7, 31)):
        # the row's own (1, 1, T, D) tensors: strides of its own, too
        solo = wkv6_cuda(*(t[b:b + 1, h:h + 1].contiguous() for t in args[:4]),
                         args[4][h:h + 1], args[5][b:b + 1, h:h + 1])
        torch.cuda.synchronize()
        assert torch.equal(solo[0], got[0][b:b + 1, h:h + 1])
        assert torch.equal(solo[1], got[1][b:b + 1, h:h + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [15, 16, 17, 49])
@pytest.mark.parametrize("Dk,Dv", [(dk, dv) for dk in (16, 32, 64) for dv in (16, 32, 64)])
def test_wkv6_every_head_pair_across_chunk_edges(cuda, Dk, Dv, T):
    """Every (Dk, Dv) pair at lengths on both sides of the 16-step chunk
    and across several ring turns, within 1e-5 of scale."""
    g = torch.Generator(device=cuda).manual_seed(Dk * 1000 + Dv * 10 + T)
    _wkv_check(_wkv_pair_inputs(2, 3, T, Dk, Dv, g, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.0, 1.0, 1e-30])
def test_wkv6_at_extreme_decays(cuda, decay):
    """w = 0, w = 1 and w ~ 1e-30 (state products below fp32's normal
    range), within 1e-5 of scale."""
    g = torch.Generator(device=cuda).manual_seed(int(decay * 10) + 3)
    _wkv_check(_wkv_pair_inputs(2, 4, 37, 64, 64, g, cuda, w=decay))


@pytest.mark.cuda
def test_wkv6_in_place_across_chunks(cuda):
    g = torch.Generator(device=cuda).manual_seed(91)
    r, k, v, w, u, s0 = _wkv_pair_inputs(3, 5, 70, 64, 32, g, cuda)
    want = wkv6_cuda(r, k, v, w, u, s0)
    state = s0.clone()
    out, sT = wkv6_cuda(r, k, v, w, u, state, inplace=True)
    torch.cuda.synchronize()
    assert sT.data_ptr() == state.data_ptr()
    assert torch.equal(out, want[0]) and torch.equal(state, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 33])
def test_wkv6_misaligned_operands_take_four_byte_copies(cuda, T):
    """Streams and state 4 bytes past a 16-byte boundary: the 4-byte
    copies and scalar state loads, the same bits as aligned copies of the
    same values."""
    g = torch.Generator(device=cuda).manual_seed(17 + T)
    args = _wkv_pair_inputs(2, 3, T, 32, 64, g, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [shifted(t.contiguous()) for t in args]
    r, k, v, w, u, s0 = moved
    assert not ls_mod.wkv_vec_ok(r, k, v, w, s0, torch.empty_like(v), torch.empty_like(s0))
    got = _wkv_check(moved)
    aligned = wkv6_cuda(*(t.contiguous() for t in args))
    torch.cuda.synchronize()
    assert torch.equal(got[0], aligned[0]) and torch.equal(got[1], aligned[1])


def _smoke_requests(cfg, spec, seed):
    rng = np.random.default_rng(seed)
    return [te.Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate(spec)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_on_the_card_lane_equals_monolithic(cuda, layout):
    """The chunked-prefill lane under the reference's (chunk, budget) grid
    gives the tokens of monolithic admission bitwise at temperature 0.8
    under ``matmul="pallas"``, both layouts, through the kernels."""
    cfg = get("smollm-360m-smoke")  # its own head_dim 16
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    spec = [(5, 6), (37, 9), (3, 4), (23, 5), (58, 4), (12, 7)]
    kv = te.KVConfig(layout="paged", block_size=16) if layout == "paged" \
        else te.KVConfig(decode_block=16)
    outs = {}
    for chunk, budget in ((0, None), (8, 8), (16, 32), (64, None)):
        scfg = te.ServeConfig(
            max_len=64, temperature=0.8, seed=11, kv=kv,
            scheduler=te.SchedulerConfig(batch=3, prefill_chunk=chunk, token_budget=budget),
            kernel=te.KernelConfig(matmul="pallas"),
        )
        for w in (dec.flash_decode_cuda, dec.flash_decode_paged_cuda, matmul_cuda):
            w.launches = 0
        res = te.Engine(cfg, params, scfg).run(_smoke_requests(cfg, spec, 5))
        assert [o.status for o in res] == [te.RequestStatus.FINISHED] * len(spec)
        kern = dec.flash_decode_paged_cuda if layout == "paged" else dec.flash_decode_cuda
        assert kern.launches > 0 and matmul_cuda.launches > 0
        outs[(chunk, budget)] = [o.tolist() for o in res]
    for key, toks in outs.items():
        assert toks == outs[(0, None)], f"lane {key} differs from monolithic admission"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_on_the_card_preempted_equals_uninterrupted(cuda, layout):
    """Under ``matmul="pallas"`` at temperature 0.8: a request admitted in a
    group of two, preempted after 5 steps, re-prefilled alone and replayed,
    ends bitwise as the uninterrupted run; so does a victim of a
    priority-5 arrival."""
    cfg = get("smollm-360m-smoke")
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0), cuda)
    kv = te.KVConfig(layout="paged", block_size=16) if layout == "paged" \
        else te.KVConfig(decode_block=16)

    def run(batch, reqs, preempt_at=None, urgent=None):
        scfg = te.ServeConfig(max_len=64, temperature=0.8, seed=13, kv=kv,
                              scheduler=te.SchedulerConfig(batch=batch, prefill_bucket=16),
                              kernel=te.KernelConfig(matmul="pallas"))
        eng = te.Engine(cfg, params, scfg)
        for r in reqs:
            eng.submit(r)
        steps = 0
        while eng.step():
            steps += 1
            if steps == preempt_at:
                assert eng.preempt(0)
            if urgent is not None and steps == 2:
                eng.submit(urgent)
        return [eng.pop_result(r.request_id) for r in reqs], eng.stats

    reqs = _smoke_requests(cfg, [(11, 14), (11, 12)], 7)
    want, _ = run(2, reqs)
    got, stats = run(2, reqs, preempt_at=5)
    assert stats["preempted"] == stats["recovered"] == 1 and stats["replayed"] == 5
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    urgent = te.Request(np.arange(1, 9, dtype=np.int32), max_new=4, request_id=9, priority=5)
    got, stats = run(1, reqs[:1], urgent=urgent)
    assert stats["preempted"] == 1 and got[0].preemptions == 1
    assert got[0].tolist() == want[0].tolist()
