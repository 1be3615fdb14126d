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
repeat bit for bit.  The conv2d kernel is held to its plain version within
one bf16 ulp of each element plus 1e-3 of the output's largest magnitude
(both sum in fp32, in other orders, and round once).  The WKV-6 kernel is
held to its plain version within 1e-5 of the output's (and the state's)
largest magnitude: both run in fp32, the kernel's sum over the key index in
one fixed order with fused multiply-adds, the plain version's through an
fp32 einsum (TF32 is off for matmuls by default).  The linear-scan kernel
(the RG-LRU's recurrence) is held to its plain version bitwise: each step
is one rounded fp32 multiply and one rounded add in both, no FMA
contraction.  Decode attention at recurrentgemma-2b's head_dim 256 and 10
query heads per KV head is held bitwise too, on a ring whose rows are
wrapped (every slot live), paged == contiguous at ``bk == block_size``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import hw
from repro_torch.arch.layers import Dispatch
from repro_torch.arch.model_zoo import build
from repro_torch.configs.registry import get
from repro_torch.kernels import abft
from repro_torch.kernels.conv2d import conv2d as cv
from repro_torch.kernels.conv2d import ops as convops
from repro_torch.kernels.flash_attention import decode_attention as dec
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
    q = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 16, 1, 64), dtype=torch.bfloat16, device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dec.flash_decode_cuda(q.float(), k, k, lens, bk=16)
    with pytest.raises(ValueError):
        dec.flash_decode_cuda(q, k, k, lens, bk=5)
    with pytest.raises(ValueError):
        dec.flash_decode_cuda(q[..., :32], k[..., :32], k[..., :32], lens, bk=16)


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
def test_gemm_rows_do_not_depend_on_m(cuda):
    """One block sums each output in a fixed order: a row's bits are the
    same whatever the other rows are (decode M and prefill M agree)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a, b = _randn((40, 960), g, cuda), _randn((960, 320), g, cuda)
    full = matmul_cuda(a, b)
    assert torch.equal(matmul_cuda(a[:8].contiguous(), b), full[:8])


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
def test_gemm_abft_rows_do_not_depend_on_m_across_the_tile_switch(cuda):
    """16 rows take the 16-row tile, 17 the 64-row tile: a row's bits stay."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a, b = _randn((17, 960), g, cuda), _randn((960, 2560), g, cuda)
    o16, _ = matmul_abft_cuda(a[:16].contiguous(), b)
    o17, _ = matmul_abft_cuda(a, b)
    assert torch.equal(o16, o17[:16])
    assert torch.equal(matmul_cuda(a[:16].contiguous(), b), matmul_cuda(a, b)[:16])


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
    cfg = dataclasses.replace(get("smollm-360m-smoke"), n_heads=6, head_dim=64)
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
    # smoke widths with the served head shape (head_dim 64, G = 3)
    cfg = dataclasses.replace(get("smollm-360m-smoke"), n_heads=6, head_dim=64)
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
    (1, 13, 11, 24, 40, 3, 2, (4, 5, 16, 32)),        # Ho, Wo not tile multiples
    (3, 9, 9, 96, 256, 3, 3, (7, 7, 32, 128)),
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
        convops.conv2d(x.float(), w.float())  # the kernel takes bf16 only


@pytest.mark.cuda
def test_conv2d_refused_launch_raises(cuda):
    """A tile whose shared memory is past the 227 KB a block may have is
    refused at launch: the wrapper raises instead of returning garbage."""
    x = torch.zeros((1, 40, 40, 512), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((5, 5, 512, 128), dtype=torch.bfloat16, device=cuda)
    t = cv.ConvTiles(1, 1, 512, 128)
    assert t.smem_bytes(5, 5) > hw.SMEM_PER_BLOCK_BYTES
    with pytest.raises(RuntimeError):
        cv.conv2d_cuda(x, w, t)
    with pytest.raises(ValueError):  # more accumulator tiles than the block holds
        cv.conv2d_cuda(x, w, cv.ConvTiles(16, 17, 16, 64))


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
    with pytest.raises(ValueError):  # head size 64 only
        wkv6_cuda(r[..., :32], k[..., :32], v[..., :32], w[..., :32], u[:, :32],
                  s0[..., :32, :32].contiguous())
    with pytest.raises(ValueError):  # one layout for all four streams
        wkv6_cuda(r, k, v.transpose(1, 2).contiguous().transpose(1, 2), w, u, s0)
    with pytest.raises(ValueError):
        wkv6_cuda(r, k, v, w, u, s0.transpose(2, 3))


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
    """recurrentgemma-2b-smoke, widened to head_dim 64 (the decode kernel
    takes 64, 128 and 256), on the card: one scan launch per rnn layer per
    prefill and decode call, one decode-attention launch per attention
    layer per decode step under ``attention="flash"``; batched output ==
    solo output through the engine."""
    cfg = dataclasses.replace(get("recurrentgemma-2b-smoke"), head_dim=64)
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
