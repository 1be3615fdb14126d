"""The port's CUDA kernels and engine on the card.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  They
import no JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same inputs.
Tolerances: decode attention to two bf16 ulps at unit scale (both sides sum
in fp32 and round once, in other orders); the GEMM to one bf16 ulp of the
output's scale.  Paged decode equals contiguous decode bitwise at
``bk == block_size``, since both run one kernel body in one order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs.registry import get
from repro_torch.kernels.flash_attention import decode_attention as dec
from repro_torch.kernels.matmul.matmul import matmul_cuda, matmul_plain
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
    plain = dec.decode_attention_plain(q, k, v, lengths, bk=bs)
    torch.testing.assert_close(contig.float(), plain.float(), rtol=2e-2, atol=2e-2)
    for window in (1, 7, 40):
        got = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths, window=window)
        want = dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


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
