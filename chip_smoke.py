#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and the ``src/repro_torch``
package beside this script; without them it exits non-zero and prints no
result.  Phases, any failure of which exits non-zero:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit as ``nvidia-smi`` gives them;
2. hold each kernel against its plain PyTorch version at the shapes of the
   serve path (smollm-360m: 5 KV heads of 3 query heads, head_dim 64, 8
   slots, a 1024-token cache, 16-token blocks; the five projection GEMMs at
   a decode and a prefill M) and time kernel, plain version and one
   PyTorch library call, each with a cold L2;
3. serve full-width smollm-360m (32 layers, random weights from a seeded
   generator) through the port's ``Engine``: 16 requests, half of them
   sharing a 256-token prefix, up to 64 greedy tokens each, in four runs
   (contiguous and paged KV, each with ``matmul="xla"`` and ``"pallas"``).
   Each run's kernel launch counts are set to 0 just before it and read
   just after; paged tokens must equal contiguous tokens;
4. the SDC defense (``KernelConfig(abft=...)``) at full width, paged KV:
   (a) the phase-3 workload with ``matmul="pallas"``, ``abft="checksum"``
   must serve the ABFT-off tokens with no detection, through the checksum
   GEMM, with its step profile beside ABFT off; (b) the weight and KV-pool
   fingerprints must repeat bit for bit 100 times; (c) seeded SDC episodes
   in both modes (``max_len`` 256, 3 slots) must detect and retry every
   compute fault once, quarantine exactly the owner of every KV flip, and
   leave survivors bitwise equal to an unfaulted oracle; (d) a weight flip
   must raise ``SDCUnlocalizedError`` before anything is emitted;
5. the paper's CONV nest: every CONV layer of AlexNet, VGG-16 and
   GoogLeNet (``core/networks.py``) at their published shapes and the
   paper's batch of 16, random bf16 inputs from a seeded generator, through
   ``kernels.conv2d.ops.conv2d``; the stride-1 layers run the CUDA kernel
   with the tile the blocking search picks for the H100 (the kernel's
   launch count over the phase must be one per stride-1 layer), the two
   strided first layers the plain oracle, as the reference routes them.
   Each kernel result is held against the plain version; per distinct
   shape the search's tile and seconds, the kernel's median time with a
   cold L2, its TFLOP/s, the bound, the plain version's time and cuDNN's
   (``F.conv2d`` on channels_last tensors, TF32 off) are printed;
6. RWKV-6 at full width (rwkv6-1.6b: 24 layers, d_model 2048, 32 WKV
   heads of 64, bf16, random weights from a seeded generator, with a
   seeded data-dependent decay: ``w0`` spread over [-6, -1] and
   ``w_lora_b`` ~ N(0, 1) in place of init's constant decay): (a) the WKV-6
   kernel against its plain version at the decode (8 rows x 32 heads, one
   step) and prefill (1 x 32, 256 steps) shapes, within 1e-5 of the
   output's and the state's scale; (b) their times with a cold L2 and the
   bound (bytes over 3.35 TB/s or 7 fp32 operations per state element and
   step over the 66.9 TFLOP/s CUDA-core peak); (c) 16 requests (prompts of
   16-256 tokens, 48-64 greedy new tokens, 8 slots, ``max_len`` 1024)
   served with ``matmul="xla"`` and ``"pallas"``: every request finished,
   the kernel launched exactly 24 times per prefill call and per decode
   step; (d) on layer 0's activations of one prefill and one decode step,
   ``ops.wkv6`` against the plain version; (e) one profiled decode step's
   card busy share and the kernel's share of it;
7. check one full-width smollm-360m decode step through the kernels against
   the plain path on the card, then print the ``kernels`` summary and, last,
   the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
L2_BYTES = 50 * 2**20
MAX_LEN, SLOTS, BS, PREFIX = 1024, 8, 16, 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _setup():
    """Import torch and the port; refuse to run without a card or without
    the repository around this script."""
    # fixed cuBLAS workspaces keep torch.matmul deterministic run to run
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible; this script measures the port on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the repro_torch package is not under {ROOT / 'src'}; run this script "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    return torch


torch = _setup()

from repro_torch import hw  # noqa: E402
from repro_torch.arch.model_zoo import build  # noqa: E402
from repro_torch.arch import layers as L  # noqa: E402
from repro_torch.arch import rwkv as R  # noqa: E402
from repro_torch.arch.transformer import Model, _index  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.core import networks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import abft  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as conv  # noqa: E402
from repro_torch.kernels.conv2d import ops as convops  # noqa: E402
from repro_torch.kernels.flash_attention import decode_attention as dec  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan as ls  # noqa: E402
from repro_torch.kernels.linear_scan import ops as lsops  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm  # noqa: E402
from repro_torch.kernels.matmul import ops as mmops  # noqa: E402
from repro_torch.serve import chaos, kvcache  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, KernelConfig, KVConfig, Request, SchedulerConfig, SDCUnlocalizedError,
    ServeConfig,
)

DEV = torch.device("cuda")
WRAPPERS = {
    "flash_decode": dec.flash_decode_cuda,
    "flash_decode_paged": dec.flash_decode_paged_cuda,
    "gemm_bf16": mm.matmul_cuda,
    "gemm_bf16_abft": mm.matmul_abft_cuda,
    "conv2d": conv.conv2d_cuda,
    "wkv6": ls.wkv6_cuda,
}
KERNEL_INFO = {
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash_attention/decode_attention.py:160"),
    "flash_decode_paged": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash_attention/decode_attention.py:315"),
    "gemm_bf16": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/matmul.py:117"),
    "gemm_bf16_abft": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/matmul.py:78"),
    "conv2d": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/conv2d.cu",
        replaces="src/repro/kernels/conv2d/conv2d.py:68"),
    "wkv6": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/linear_scan/linear_scan.py:112"),
}
# the five projection GEMMs of smollm-360m: (K, N, B transposed)
GEMM_SHAPES = [(960, 960, False), (960, 320, False), (960, 2560, False),
               (2560, 960, False), (960, 49152, True)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing --

_flush_buf = None


def time_samples(fn, iters: int = 20) -> list[float]:
    """Device time in ms of ``fn`` in each of ``iters`` launches, each after
    the L2 cache was overwritten (the serve path finds its weights and KV
    cold: a decode step streams far more than 50 MB).  A spin kernel
    before the start event keeps the card busy while the host enqueues
    ``fn``, so the host's launch overhead stays out of the reading."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(2):
        fn()
    out = []
    for _ in range(iters):
        _flush_buf.zero_()
        torch.cuda._sleep(1_000_000)  # about half a millisecond of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def time_ms(fn, iters: int = 20) -> float:
    """Mean of :func:`time_samples`."""
    return statistics.fmean(time_samples(fn, iters))


def bound_ms(nbytes: float, flops: float, peak: float = hw.BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate or operations
    over ``peak`` (the bf16 tensor-core rate unless the work is fp32 on the
    CUDA cores), whichever is larger."""
    t_b, t_f = nbytes / hw.HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ----------------------------------------------------------- kernel phase --


def check_decode(results: dict) -> None:
    """Both decode-attention kernels at the serve shapes against their
    plain versions; paged must equal contiguous bitwise at bk == bs."""
    B, KV, G, d, S = SLOTS, 5, 3, 64, MAX_LEN
    g = torch.Generator(device=DEV).manual_seed(1)
    q = torch.randn((B, KV, G, d), generator=g, device=DEV).bfloat16()
    k = torch.randn((B, S, KV, d), generator=g, device=DEV).bfloat16()
    v = torch.randn((B, S, KV, d), generator=g, device=DEV).bfloat16()
    lengths = torch.tensor([0, 1, 17, 100, 255, 300, 777, 1024], dtype=torch.int32, device=DEV)
    n_blk = S // BS
    perm = torch.randperm(B * n_blk, generator=g, device=DEV) + 1
    tables = perm.reshape(B, n_blk).to(torch.int32)
    kpool = torch.randn((B * n_blk + 1, BS, KV, d), generator=g, device=DEV).bfloat16()
    vpool = torch.randn_like(kpool)
    kpool[tables.long()] = k.reshape(B, n_blk, BS, KV, d)
    vpool[tables.long()] = v.reshape(B, n_blk, BS, KV, d)

    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=BS)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    torch.cuda.synchronize()
    if not torch.equal(contig, paged):
        fail("paged decode attention differs from contiguous at bk == block_size")
    print("decode attention: paged == contiguous bitwise at bk == block_size = 16")

    live = torch.clamp(lengths, 1, S).long()
    live_keys = int(live.sum())
    n_live_blocks = int(((live + BS - 1) // BS).sum())
    qo_bytes = 2 * q.numel() * 2 + lengths.numel() * 4
    kv_bytes = live_keys * KV * d * 2 * 2
    flops = live_keys * KV * G * d * 4

    # the library yardstick: one SDPA call on K/V gathered to (B, H, S, d)
    idx = torch.arange(S, device=DEV)
    mask = (idx[None, :] < live[:, None])[:, None, None, :]
    qh = q.reshape(B, KV * G, 1, d)

    def heads(t):  # (B, S, KV, d) -> (B, KV*G, S, d), G-fold repeated
        return t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()

    kh, vh = heads(k), heads(v)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    cases = {
        "flash_decode": (
            contig, lambda: dec.decode_attention_plain(q, k, v, lengths, bk=BS),
            lambda: dec.flash_decode_cuda(q, k, v, lengths, bk=BS), 0,
        ),
        "flash_decode_paged": (
            paged, lambda: dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths),
            lambda: dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths),
            n_live_blocks * 4,
        ),
    }
    for name, (got, plain_fn, kern_fn, extra_bytes) in cases.items():
        want = plain_fn()
        err = (got.float() - want.float()).abs()
        # bitwise: kernel and plain version sum order-independently (fp64
        # accumulation, one rounding), which the ABFT fingerprint needs
        if not torch.equal(got, want):
            fail(f"{name}: kernel differs from the plain version in "
                 f"{int((got != want).sum())} elements (max |diff| {float(err.max()):.3e}); "
                 f"they must be bitwise equal")
        b_ms, b_by = bound_ms(qo_bytes + kv_bytes + extra_bytes, flops)
        results[name] = dict(
            max_abs_err=float(err.max()), tolerance="bitwise",
            ms=time_ms(kern_fn), plain_ms=time_ms(plain_fn, iters=5),
            library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} KV={KV} G={G} d={d} S={S} bs={BS} live_keys={live_keys}",
        )
        print(f"{name}: max_abs_err={results[name]['max_abs_err']:.3e} "
              f"(bitwise) ms={results[name]['ms']:.4f} "
              f"plain_ms={results[name]['plain_ms']:.4f} "
              f"library_ms={results[name]['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)


def check_gemm(results: dict, prefill_m: int) -> None:
    """The GEMM kernel at the five projection shapes of smollm-360m, at the
    decode M (slots) and a prefill M, against its plain version."""
    g = torch.Generator(device=DEV).manual_seed(2)
    rows = []
    for M in (SLOTS, prefill_m):
        for K, N, trans_b in GEMM_SHAPES:
            a = torch.randn((M, K), generator=g, device=DEV).bfloat16()
            b = torch.randn((N, K) if trans_b else (K, N), generator=g, device=DEV).bfloat16()
            got = mm.matmul_cuda(a, b, trans_b=trans_b)
            want = mm.matmul_plain(a, b, trans_b=trans_b)
            err = float((got.float() - want.float()).abs().max())
            # one bf16 ulp at the output's scale: both sides accumulate in
            # fp32 (in other orders) and round once at the store
            tol = 2.0**-7 * float(want.float().abs().max())
            if err > tol:
                fail(f"gemm {M}x{K}x{N} trans_b={trans_b}: max err {err:.3e} > {tol:.3e}")
            lib = (lambda a=a, b=b: a @ b.T) if trans_b else (lambda a=a, b=b: a @ b)
            b_ms, b_by = bound_ms((M * K + K * N + M * N) * 2, 2.0 * M * N * K)
            row = dict(
                M=M, K=K, N=N, trans_b=trans_b, max_abs_err=err, tolerance=tol,
                ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_cuda(a, b, trans_b=t)),
                plain_ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_plain(a, b, trans_b=t)),
                library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
            )
            rows.append(row)
            print(f"gemm M={M} K={K} N={N} trans_b={trans_b}: max_abs_err={err:.3e} "
                  f"(tol {tol:.3e}) ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})",
                  flush=True)
    # the summary line carries the sums over one decode step's shapes
    # (M = slots), the case the serve loop runs most
    dec_rows = [r for r in rows if r["M"] == SLOTS]
    results["gemm_bf16"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in dec_rows), plain_ms=sum(r["plain_ms"] for r in dec_rows),
        library_ms=sum(r["library_ms"] for r in dec_rows),
        bound_ms=sum(r["bound_ms"] for r in dec_rows), bound_by="bytes",
        shape="sum over the five (K,N) projection shapes at M=8",
        cases=rows,
    )


def check_gemm_abft(results: dict, prefill_m: int) -> None:
    """The checksum GEMM at the five projection shapes, at the decode M of
    the ABFT path (slots + the checksum row), at M = 17 (past the 16-row
    tile) and at a prefill M: its product bitwise ``gemm_bf16``'s, both
    outputs the same bits on a second run, the product within one bf16 ulp
    of the plain version and the checksums within the ABFT tolerance
    ``ABFT_ATOL + ABFT_RTOL * (e^T|A|)|B|`` of the plain version's (the
    verdict's own bound; both sum fp32 in other orders)."""
    g = torch.Generator(device=DEV).manual_seed(4)
    rows = []
    for M in (SLOTS + 1, 17, prefill_m + 1):
        for K, N, trans_b in GEMM_SHAPES:
            a = torch.randn((M, K), generator=g, device=DEV).bfloat16()
            b = torch.randn((N, K) if trans_b else (K, N), generator=g, device=DEV).bfloat16()
            out, checks = mm.matmul_abft_cuda(a, b, trans_b=trans_b)
            out2, checks2 = mm.matmul_abft_cuda(a, b, trans_b=trans_b)
            base = mm.matmul_cuda(a, b, trans_b=trans_b)
            torch.cuda.synchronize()
            case = f"gemm_abft {M}x{K}x{N} trans_b={trans_b}"
            if not torch.equal(out, base):
                fail(f"{case}: product differs from gemm_bf16's")
            if not (torch.equal(out2, out) and torch.equal(checks2, checks)):
                fail(f"{case}: a second run gave other bits")
            want, want_checks = mm.matmul_abft_plain(a, b, trans_b=trans_b)
            err = float((out.float() - want.float()).abs().max())
            tol = 2.0**-7 * float(want.float().abs().max())
            bm = mm.abft_block_rows(M)
            nrb = checks.shape[0]
            a_abs = torch.nn.functional.pad(a.float().abs(), (0, 0, 0, nrb * bm - M))
            bl = (b.T if trans_b else b).float()
            scale = a_abs.reshape(nrb, bm, K).sum(1) @ bl.abs()
            c_err = (checks - want_checks).abs()
            if err > tol or bool((c_err > abft.ABFT_ATOL + abft.ABFT_RTOL * scale).any()):
                fail(f"{case}: product err {err:.3e} (tol {tol:.3e}) or checksum err "
                     f"{float(c_err.max()):.3e} beyond the ABFT tolerance")
            if bool(mmops.matmul_abft(a, b, trans_b=trans_b)[1]):
                fail(f"{case}: the verdict flagged a clean product")
            row = dict(M=M, K=K, N=N, trans_b=trans_b, max_abs_err=err, tolerance=tol,
                       checks_max_abs_err=float(c_err.max()))
            if M == SLOTS + 1:

                def lib(a=a, b=b, t=trans_b, nrb=nrb, bm=bm, M=M):
                    c = (a @ b.T) if t else (a @ b)
                    pad = torch.nn.functional.pad(c.float(), (0, 0, 0, nrb * bm - M))
                    return c, pad.reshape(nrb, bm, -1).sum(1)

                b_ms, b_by = bound_ms((M * K + K * N + M * N) * 2 + nrb * N * 4,
                                      2.0 * M * N * K + M * N)
                row.update(
                    ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_abft_cuda(a, b, trans_b=t)),
                    plain_ms=time_ms(
                        lambda a=a, b=b, t=trans_b: mm.matmul_abft_plain(a, b, trans_b=t)),
                    library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
                    gemm_bf16_ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_cuda(a, b, trans_b=t)),
                )
            rows.append(row)
            print(f"{case}: max_abs_err={err:.3e} (tol {tol:.3e}) checksum err "
                  f"{row['checks_max_abs_err']:.3e}" + (
                      f" ms={row['ms']:.4f} (gemm_bf16 {row['gemm_bf16_ms']:.4f}) "
                      f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                      if "ms" in row else ""), flush=True)
    # a row's bits do not depend on M, across the 16 -> 17 tile switch
    a = torch.randn((17, 960), generator=g, device=DEV).bfloat16()
    b = torch.randn((960, 2560), generator=g, device=DEV).bfloat16()
    o16, _ = mm.matmul_abft_cuda(a[:16].contiguous(), b)
    o17, _ = mm.matmul_abft_cuda(a, b)
    if not torch.equal(o16, o17[:16]):
        fail("gemm_abft: rows changed between M = 16 and M = 17")
    print("gemm_abft: product == gemm_bf16 bitwise, repeat runs bitwise, rows equal "
          "across the M = 16 -> 17 tile switch", flush=True)
    dec_rows = [r for r in rows if r["M"] == SLOTS + 1]
    results["gemm_bf16_abft"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in dec_rows), plain_ms=sum(r["plain_ms"] for r in dec_rows),
        library_ms=sum(r["library_ms"] for r in dec_rows),
        bound_ms=sum(r["bound_ms"] for r in dec_rows), bound_by="bytes",
        shape=f"sum over the five (K,N) projection shapes at M={SLOTS + 1}",
        cases=rows,
    )


# ------------------------------------------------------------ serve phase --


def workload(cfg, seed: int = 0) -> list:
    """16 requests.  The first 8 share a 256-token prefix with tails of
    1-15 tokens (two tails equal, so their shared tail block is copied on
    write); all 8 pad to one prefill bucket and are admitted together, so
    every aliased block comes from the same prefill call as the request
    that aliases it.  The other 8 are independent prompts of 64-320
    tokens.  Budgets are 48-64 new tokens."""
    rng = torch.Generator().manual_seed(seed)

    def ints(n, hi):
        return torch.randint(0, hi, (n,), generator=rng).numpy().astype(np.int32)

    prefix = ints(PREFIX, cfg.vocab)
    tails = [ints(int(n), cfg.vocab) for n in ints(8, 15) + 1]
    tails[1] = tails[0]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    prompts += [ints(int(n), cfg.vocab) for n in ints(8, 257) + 64]
    budgets = [int(b) for b in ints(16, 17) + 48]
    return [Request(p, max_new=b, request_id=i)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def serve_once(cfg, params, layout: str, matmul: str, reqs: list, abft_mode: str = "off"):
    kv = (KVConfig(layout="paged", block_size=BS) if layout == "paged"
          else KVConfig(decode_block=BS))
    scfg = ServeConfig(
        max_len=MAX_LEN,
        scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=kv, kernel=KernelConfig(matmul=matmul, attention="flash", abft=abft_mode),
    )
    eng = Engine(cfg, params, scfg, device=DEV)
    stamps: dict[int, list[float]] = {}

    def on_token(rid, tok, idx, done):
        stamps.setdefault(rid, []).append(time.perf_counter())

    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run(reqs, on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}

    bad = [(i, o.status.value, len(o)) for i, o in enumerate(outs)
           if o.status.value != "FINISHED" or len(o) != reqs[i].max_new]
    if bad:
        fail(f"{layout}/{matmul}: requests did not finish their budgets: {bad}")
    toks = [o.tolist() for o in outs]
    if not all(0 <= t < cfg.vocab for row in toks for t in row):
        fail(f"{layout}/{matmul}: a token is out of the vocabulary")
    if eng.pool is not None:
        eng.pool.assert_invariants(eng.live_block_refs())
        if eng.pool.free_blocks != eng.pool.num_blocks - 1:
            fail(f"{layout}/{matmul}: blocks leaked after drain")
    itl = sorted(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    ttft = sorted(ts[0] - t0 for ts in stamps.values())
    n_tok = sum(len(t) for t in toks)

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(len(xs) * p))] * 1e3

    res = dict(
        layout=layout, matmul=matmul, abft=abft_mode, tokens=n_tok, wall_s=wall,
        tok_per_s=n_tok / wall, sdc_detected=eng.stats["sdc_detected"],
        itl_p50_ms=pct(itl, 0.5), itl_p95_ms=pct(itl, 0.95), ttft_p50_ms=pct(ttft, 0.5),
        launches=launches, peak_active=eng.stats["peak_active"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(f"serve {layout:10s} matmul={matmul:6s} abft={abft_mode}: {n_tok} tokens in {wall:.3f} s "
          f"= {res['tok_per_s']:.1f} tok/s, ITL p50 {res['itl_p50_ms']:.2f} ms "
          f"p95 {res['itl_p95_ms']:.2f} ms, TTFT p50 {res['ttft_p50_ms']:.1f} ms, "
          f"launches {launches}", flush=True)
    return res, toks, eng


class HostTimer:
    """Host wall time spent inside some functions, and their calls, by
    name: wraps each attribute ``obj.name`` in place (undone by
    :meth:`restore`).  The step is host-bound, so the host time a part of
    it takes is its cost."""

    def __init__(self, targets: dict):
        self.ms = {k: 0.0 for k in targets}
        self.calls = {k: 0 for k in targets}
        self._saved = []
        for key, (obj, name) in targets.items():
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))

            def timed(*a, _fn=fn, _key=key, **kw):
                self.calls[_key] += 1
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.ms[_key] += (time.perf_counter() - t) * 1e3

            setattr(obj, name, timed)

    def restore(self):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def profile_decode(cfg, params, reqs, steps: int = 8, layout: str = "contiguous",
                   abft_mode: str = "off", focus: str | None = None) -> dict:
    """Where a decode step's time goes on the kernel path
    (``matmul="pallas"``): host wall time per step without the profiler,
    then the card's busy time per step from ``torch.profiler`` (the union
    of the CUDA kernels' intervals) and the kernels that take most of it.
    With ABFT on, also the host time per step inside the attention
    fingerprint, the checked GEMMs (``AbftTrace.mm`` in all), the verdict
    op ``ops.matmul_abft`` and the checksum kernel's wrapper.  With
    ``focus``, also the card time per step of the kernels whose name holds
    it, and their share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kv = KVConfig(layout="paged", block_size=BS) if layout == "paged" else KVConfig(decode_block=BS)
    scfg = ServeConfig(
        max_len=MAX_LEN, scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=kv, kernel=KernelConfig(matmul="pallas", abft=abft_mode),
    )
    eng = Engine(cfg, params, scfg, device=DEV)
    for r in reqs[:SLOTS]:
        eng.submit(r)
    for _ in range(3):  # admission, then warm decode steps
        eng.step()
    timer = None
    if abft_mode != "off":
        timer = HostTimer({
            "fingerprint": (abft.AbftTrace, "check_paged_attention"),
            "checked_gemms": (abft.AbftTrace, "mm"),
            "verdict_op": (mmops, "matmul_abft"),
            "checksum_kernel_wrapper": (mmops, "matmul_abft_cuda"),
        })
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    host_parts = None
    if timer is not None:
        timer.restore()
        host_parts = {k: v / steps for k, v in timer.ms.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:  # union of kernel intervals, in microseconds
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    focus_ms = None
    if focus is not None:
        focus_ms = sum(t for n, t in by_name.items() if focus in n) / steps / 1e3
    res = dict(
        layout=layout, abft=abft_mode,
        step_ms=step_ms, device_busy_ms_per_step=busy / steps / 1e3,
        busy_share=busy / steps / 1e3 / step_ms if spans else None,
        top_kernels_ms_per_step={n[:80]: t / steps / 1e3 for n, t in top},
        host_ms_per_step=host_parts, focus=focus, focus_ms_per_step=focus_ms,
        focus_share_of_busy=focus_ms / (busy / steps / 1e3) if focus_ms is not None and spans
        else None,
    )
    print(f"decode step ({cfg.name}, {layout}, pallas, abft={abft_mode}, {SLOTS} live rows): "
          f"{step_ms:.2f} ms wall, card busy {res['device_busy_ms_per_step']:.3f} ms per step "
          f"(share of wall {res['busy_share']})", flush=True)
    for n, t in res["top_kernels_ms_per_step"].items():
        print(f"  {t:.3f} ms/step  {n}")
    for n, t in (host_parts or {}).items():
        print(f"  host {t:.2f} ms/step inside {n}")
    if focus is not None:
        print(f"  {focus}: {focus_ms:.3f} ms/step of card time, share of busy "
              f"{res['focus_share_of_busy']}", flush=True)
    return res


SDC_MAX_LEN, SDC_SLOTS = 256, 3
SDC_MIXES = [(1, 1), (2, 1), (1, 2), (0, 1), (2, 0), (1, 1)]  # tests/test_sdc.py:175


def sdc_engines(cfg, params, mode: str):
    """An ABFT engine and its unfaulted oracle (contiguous KV, the paged
    block size as its decode split), both on the M-invariant GEMM kernel,
    sampling at temperature 0.7 as the reference's episode tests do."""
    common = dict(max_len=SDC_MAX_LEN, temperature=0.7, seed=5)
    eng = Engine(cfg, params, ServeConfig(
        scheduler=SchedulerConfig(batch=SDC_SLOTS, prefill_bucket=16, stall_patience=6),
        kv=KVConfig(layout="paged", block_size=BS),
        kernel=KernelConfig(matmul="pallas", abft=mode), **common), device=DEV)
    oracle = Engine(cfg, params, ServeConfig(
        scheduler=SchedulerConfig(batch=SDC_SLOTS, prefill_bucket=16),
        kv=KVConfig(decode_block=BS), kernel=KernelConfig(matmul="pallas"), **common),
        device=DEV)
    return eng, oracle


def sdc_phase(cfg, params, reqs, off_run: dict, off_tokens: list, totals: dict) -> dict:
    """Phase 4, (a)-(d) of the module docstring."""
    out: dict = {}
    print("-- (a) the phase-3 workload with abft='checksum'", flush=True)
    res, toks, eng = serve_once(cfg, params, "paged", "pallas", reqs, abft_mode="checksum")
    for n, c in res["launches"].items():
        totals[n] += c
    if res["launches"]["gemm_bf16_abft"] <= 0:
        fail("abft serve run: the checksum GEMM was never launched")
    if res["sdc_detected"]:
        fail(f"abft serve run: {res['sdc_detected']} detections on a clean run")
    if toks != off_tokens:
        fail("abft serve run: tokens differ from the abft-off paged/pallas run")
    print(f"abft=checksum tokens == abft=off tokens, 0 detections; tokens/s "
          f"{res['tok_per_s']:.1f} vs {off_run['tok_per_s']:.1f} off, ITL p50/p95 "
          f"{res['itl_p50_ms']:.2f}/{res['itl_p95_ms']:.2f} ms vs "
          f"{off_run['itl_p50_ms']:.2f}/{off_run['itl_p95_ms']:.2f} ms off", flush=True)
    out["serve_abft"] = res
    out["profile"] = [profile_decode(cfg, params, reqs, layout="paged", abft_mode=m)
                      for m in ("off", "checksum")]

    print("-- (b) fingerprints repeat bit for bit", flush=True)
    w0 = abft.weight_sums(eng.params)
    p0 = eng._pool_sums()
    same_w = torch.equal(w0, eng._wsums0) and all(
        torch.equal(abft.weight_sums(eng.params), w0) for _ in range(100))
    same_p = all(np.array_equal(eng._pool_sums(), p0) for _ in range(100))
    if not (same_w and same_p):
        fail(f"fingerprints changed on repeats: weight_sums {same_w}, pool sums {same_p}")
    print(f"weight_sums ({w0.numel()} leaves) and pool sums ({p0.size} blocks): "
          f"100 repeats bitwise equal", flush=True)
    del eng

    print(f"-- (c) seeded SDC episodes (max_len {SDC_MAX_LEN}, {SDC_SLOTS} slots, "
          f"{len(SDC_MIXES)} episodes: the test matrix's fault mixes once, modes "
          f"alternating; cut from the tests' SDC_EPISODES-driven count)", flush=True)
    setups = {m: sdc_engines(cfg, params, m) for m in ("checksum", "paranoid")}
    reports = []
    for ep, (n_compute, n_kv) in enumerate(SDC_MIXES):
        mode = ("checksum", "paranoid")[ep % 2]
        eng, oracle_eng = setups[mode]
        seed = chaos.SEED_STRIDE + ep
        ereqs = chaos.make_sdc_workload(np.random.default_rng(seed), cfg.vocab, SDC_MAX_LEN)
        t0 = time.perf_counter()
        try:
            oracle = chaos.oracle_outputs(oracle_eng, ereqs)
            rep = chaos.run_sdc_episode(eng, oracle, ereqs, seed, n_compute=n_compute, n_kv=n_kv)
        except AssertionError as e:
            fail(f"sdc episode {ep} ({mode}): {e}")
        reports.append(dict(dataclasses.asdict(rep), mode=mode, s=time.perf_counter() - t0))
        print(f"episode {ep} {mode}: {rep.steps} steps, injected {rep.injected}, detected "
              f"{rep.detected}, retried {rep.retried}, quarantined {rep.quarantined}, "
              f"{rep.statuses} ({reports[-1]['s']:.1f} s)", flush=True)
    fired = sum(r["injected"]["compute"] for r in reports), sum(r["injected"]["kv"] for r in reports)
    if not (fired[0] and fired[1]):
        fail(f"sdc episodes: a fault surface never fired (compute, kv) = {fired}")
    out["episodes"] = reports

    print("-- (d) a weight flip raises before anything is emitted", flush=True)
    eng, _ = setups["checksum"]
    rng = np.random.default_rng(41)
    for i in range(SDC_SLOTS):
        eng.submit(Request(rng.integers(0, cfg.vocab, 10).astype(np.int32), max_new=16,
                           request_id=i))
    emitted = []
    for _ in range(3):
        eng.step(on_token=lambda *a: emitted.append(a))
    n_before = len(emitted)
    eng.params, leaf = chaos.flip_weight_bit(eng.params, rng)
    try:
        eng.step(on_token=lambda *a: emitted.append(a))
        fail("a weight flip did not raise SDCUnlocalizedError")
    except SDCUnlocalizedError as e:
        if len(emitted) != n_before:
            fail("tokens were emitted on the step that found the weight flip")
        print(f"weight flip in leaf {leaf}: SDCUnlocalizedError ({e}), nothing emitted",
              flush=True)
    out["weight_flip_leaf"] = leaf
    return out


CONV_BATCH = 16  # the paper's batch for its CNNs (core/networks.py)


def conv_layers() -> list[tuple]:
    """(network, layer, stride, bounds) of every CONV layer of the paper's
    AlexNet, VGG-16 and GoogLeNet tables at their published shapes."""
    out = []
    for net in ("alexnet", "vgg16", "googlenet"):
        for nest in getattr(networks, net)(CONV_BATCH):
            b = nest.bounds
            if b["X"] * b["Y"] * b["FX"] * b["FY"] == 1:
                continue  # a fully connected layer
            out.append((net, nest.name, nest.tensor("I").coupled["X"][1], dict(b)))
    return out


def conv_phase(totals: dict, results: dict) -> dict:
    """Phase 5 of the module docstring."""
    layers = conv_layers()
    shapes: dict[tuple, dict] = {}
    print("-- tiles from the blocking search on the (SMEM, HBM) hierarchy (set-up, "
          "outside every timed window)", flush=True)
    for net, name, stride, b in layers:
        key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
        if stride != 1:
            continue
        if key in shapes:
            shapes[key]["layers"].append(f"{net}/{name}")
            continue
        t0 = time.perf_counter()
        tiles = convops.choose_conv_blocks(CONV_BATCH, *key)
        secs = time.perf_counter() - t0
        shapes[key] = dict(layers=[f"{net}/{name}"], tiles=tiles, search_s=secs)
        print(f"{net}/{name} X=Y={b['X']} C={b['C']} K={b['K']} F={b['FX']}x{b['FY']}: "
              f"tile (bx,by,bc,bk)=({tiles.bx},{tiles.by},{tiles.bc},{tiles.bk}), "
              f"search {secs:.3f} s, smem {tiles.smem_bytes(b['FX'], b['FY'])} B, "
              f"{tiles.warp_tiles()} warp tiles", flush=True)

    g = torch.Generator(device=DEV).manual_seed(7)
    data = []
    for net, name, stride, b in layers:
        x = torch.randn((CONV_BATCH, (b["X"] - 1) * stride + b["FX"],
                         (b["Y"] - 1) * stride + b["FY"], b["C"]),
                        generator=g, device=DEV).bfloat16()
        w = torch.randn((b["FX"], b["FY"], b["C"], b["K"]), generator=g, device=DEV).bfloat16()
        data.append((x, w))

    print("-- the main path: ops.conv2d on every CONV layer", flush=True)
    for wr in WRAPPERS.values():
        wr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [convops.conv2d(x, w, stride=stride)
            for (x, w), (_, _, stride, _) in zip(data, layers)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: wr.launches for n, wr in WRAPPERS.items()}
    n_stride1 = sum(1 for layer in layers if layer[2] == 1)
    if launches["conv2d"] != n_stride1 or launches["conv2d"] <= 0:
        fail(f"conv2d: {launches['conv2d']} kernel launches over {n_stride1} stride-1 layers")
    if any(c for n, c in launches.items() if n != "conv2d"):
        fail(f"conv phase launched other kernels: {launches}")
    totals["conv2d"] += launches["conv2d"]
    print(f"{len(layers)} CONV layers in {wall:.3f} s (host clock), conv2d launched "
          f"{launches['conv2d']} times ({n_stride1} stride-1 layers x 1)", flush=True)

    print("-- each layer against the plain version (tolerance per element: one bf16 ulp "
          "of the element + 1e-3 of the output's max |value|)", flush=True)
    max_err = 0.0
    for (x, w), out, (net, name, stride, b) in zip(data, outs, layers):
        shape = (CONV_BATCH, b["X"], b["Y"], b["K"])
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"conv {net}/{name}: output {tuple(out.shape)} (want {shape}) or not finite")
        if stride != 1:
            print(f"{net}/{name}: routed to plain (stride {stride})", flush=True)
            continue
        key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
        want = conv.conv2d_plain(x, w, shapes[key]["tiles"]).float()
        err = (out.float() - want).abs()
        # both sum in fp32 in other orders and round once to bf16
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
        tol = ulp + 1e-3 * float(want.abs().max())
        n_bad = int((err > tol).sum())
        if n_bad:
            fail(f"conv {net}/{name}: {n_bad} elements beyond tolerance "
                 f"(max |diff| {float(err.max()):.3e})")
        max_err = max(max_err, float(err.max()))
        print(f"{net}/{name}: max |diff| {float(err.max()):.3e}, within tolerance", flush=True)
        del want, err, ulp, tol
    del outs

    print("-- per distinct shape: times with a cold L2 (kernel and cuDNN: median of 20, "
          "cuDNN with TF32 off; plain: mean of 3)", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    rows = []
    for (x, w), (net, name, stride, b) in zip(data, layers):
        key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
        if stride != 1 or "ms" in shapes[key]:
            continue
        sh = shapes[key]
        tiles = sh["tiles"]
        xn = x.permute(0, 3, 1, 2)  # NHWC storage = NCHW channels_last
        wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        flops = 2.0 * CONV_BATCH * b["X"] * b["Y"] * b["C"] * b["K"] * b["FX"] * b["FY"]
        nbytes = 2 * (x.numel() + w.numel() + CONV_BATCH * b["X"] * b["Y"] * b["K"])
        b_ms, b_by = bound_ms(nbytes, flops)
        sh.update(
            ms=statistics.median(time_samples(lambda x=x, w=w, t=tiles: conv.conv2d_cuda(x, w, t))),
            plain_ms=time_ms(lambda x=x, w=w, t=tiles: conv.conv2d_plain(x, w, t), iters=3),
            library_ms=statistics.median(
                time_samples(lambda xn=xn, wn=wn: torch.nn.functional.conv2d(xn, wn))),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        )
        sh["tflops"] = flops / sh["ms"] / 1e9
        rows.append(dict(shape=dict(X=b["X"], Y=b["Y"], C=b["C"], K=b["K"], FX=b["FX"],
                                    FY=b["FY"]),
                         tiles=dataclasses.asdict(tiles),
                         **{k: v for k, v in sh.items() if k != "tiles"}))
        print(f"{','.join(sh['layers'])} (X=Y={b['X']} C={b['C']} K={b['K']} "
              f"F={b['FX']}x{b['FY']}): tile ({tiles.bx},{tiles.by},{tiles.bc},{tiles.bk}) "
              f"search {sh['search_s']:.3f} s; ms={sh['ms']:.4f} ({sh['tflops']:.1f} TFLOP/s) "
              f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={sh['plain_ms']:.4f} "
              f"library_ms={sh['library_ms']:.4f}", flush=True)
    del data

    # the pass: every stride-1 layer once (shapes that repeat count each time)
    def total(k):
        return sum(sh[k] * len(sh["layers"]) for sh in shapes.values())

    by_flops = total("flops") / hw.BF16_FLOPS_PER_S >= total("bytes") / hw.HBM_BYTES_PER_S
    results["conv2d"] = dict(
        max_abs_err=max_err, ms=total("ms"), plain_ms=total("plain_ms"),
        library_ms=total("library_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if by_flops else "bytes",
        shape=f"sum over the {n_stride1} stride-1 CONV layers of AlexNet, VGG-16 and "
              f"GoogLeNet at batch {CONV_BATCH}",
    )
    print(f"conv2d over the pass ({n_stride1} layers, {total('flops') / 1e12:.3f} TFLOP): "
          f"ms={results['conv2d']['ms']:.4f} ({total('flops') / results['conv2d']['ms'] / 1e9:.1f} "
          f"TFLOP/s) bound_ms={results['conv2d']['bound_ms']:.4f} "
          f"plain_ms={results['conv2d']['plain_ms']:.4f} "
          f"library_ms={results['conv2d']['library_ms']:.4f}", flush=True)
    return dict(layers=[dict(net=n, layer=m, stride=s) for n, m, s, _ in layers],
                launches=launches["conv2d"], main_path_wall_s=wall, shapes=rows)


# ------------------------------------------------------------- rwkv phase --

WKV_TOL = 1e-5  # of the output's (and the state's) largest magnitude
WKV_SHAPES = {"decode": (SLOTS, 32, 1), "prefill": (1, 32, 256)}  # (B, H, T)


def wkv_inputs(B: int, H: int, T: int, g) -> tuple:
    """Seeded fp32 operands at the model's layout: (B, H, T, 64) views of
    (B, T, H, 64) streams, a decay w in (0, 1) that varies per step and
    channel, u ~ N(0, 0.5) and a state s0 ~ N(0, 1)."""
    def stream():
        return torch.randn((B, T, H, 64), generator=g, device=DEV).transpose(1, 2)

    r, k, v = stream(), stream(), stream()
    w = torch.exp(-torch.exp(stream() - 1.0))
    u = 0.5 * torch.randn((H, 64), generator=g, device=DEV)
    s0 = torch.randn((B, H, 64, 64), generator=g, device=DEV)
    return r, k, v, w, u, s0


def wkv_err(got, want) -> tuple[float, float]:
    """(max |diff| of out and state, the tolerance from their scales);
    fails beyond it."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    tol = WKV_TOL * max(float(b.abs().max()) for b in want)
    return err, tol


def check_wkv6(results: dict) -> None:
    """(a) and (b) of phase 6: the WKV-6 kernel against its plain version
    at the serve path's decode and prefill shapes, and its times."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain einsum in full fp32
    g = torch.Generator(device=DEV).manual_seed(8)
    rows = {}
    for case, (B, H, T) in WKV_SHAPES.items():
        args = wkv_inputs(B, H, T, g)
        got = ls.wkv6_cuda(*args)
        want = ls.wkv6_plain(*args)
        torch.cuda.synchronize()
        err, tol = wkv_err(got, want)
        if not err <= tol:
            fail(f"wkv6 {case} B={B} H={H} T={T}: max err {err:.3e} > {tol:.3e}")
        # each input read once (r, k, v, w, u, s0), each output written once
        # (out, s_T); 7 fp32 operations per state element per step
        nbytes = 4 * (5 * B * H * T * 64 + H * 64 + 2 * B * H * 64 * 64)
        flops = 7.0 * B * H * T * 64 * 64
        b_ms, b_by = bound_ms(nbytes, flops, hw.FP32_FLOPS_PER_S)
        rows[case] = row = dict(
            B=B, H=H, T=T, max_abs_err=err, tolerance=tol,
            ms=time_ms(lambda a=args: ls.wkv6_cuda(*a)),
            plain_ms=time_ms(lambda a=args: ls.wkv6_plain(*a), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
        )
        print(f"wkv6 {case} B={B} H={H} T={T}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.5f} "
              f"({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP); "
              f"library_ms: none (no single PyTorch call computes the recurrence)",
              flush=True)
    # the summary line carries the decode shape, the call the serve loop
    # makes most (24 per step); both shapes are in build/chip_smoke.json
    results["wkv6"] = dict(rows["decode"], shape="decode: B=8 H=32 T=1 D=64", cases=rows)


def rwkv_params(cfg) -> dict:
    """Full-width random weights from a seeded generator, with a seeded
    data-dependent decay in place of init's constant one."""
    params = build(cfg).init(torch.Generator(device=DEV).manual_seed(0), DEV)
    g = torch.Generator(device=DEV).manual_seed(1)
    wkv = params["layers"]["wkv"]
    wkv["w_lora_b"].copy_(torch.randn(wkv["w_lora_b"].shape, generator=g, device=DEV))
    wkv["w0"].uniform_(-6.0, -1.0, generator=g)
    return params


def rwkv_workload(cfg, seed: int = 0) -> list:
    """16 requests, prompts of 16-256 tokens and budgets of 48-64 new
    tokens, all drawn from a seeded generator."""
    rng = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 257, (16,), generator=rng).tolist()
    budgets = torch.randint(48, 65, (16,), generator=rng).tolist()
    return [Request(torch.randint(0, cfg.vocab, (n,), generator=rng).numpy().astype(np.int32),
                    max_new=b, request_id=i)
            for i, (n, b) in enumerate(zip(lens, budgets))]


def check_rwkv_layer(cfg, params) -> dict:
    """(d) of phase 6: ``ops.wkv6`` against the plain version on layer 0's
    operands of a 200-token prefill and of the decode step after it."""
    model = build(cfg)
    p0 = _index(params["layers"], 0)
    g = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(0, cfg.vocab, (1, 200), generator=g, device=DEV)
    step = torch.randint(0, cfg.vocab, (1, 1), generator=g, device=DEV)
    caches = kvcache.build_caches(cfg, 1, MAX_LEN, DEV)
    out = {}
    for case, tk in (("prefill", toks), ("decode", step)):
        x = L.rmsnorm(p0["ln1"], L.embed(params["embed"], tk), cfg.norm_eps)
        r, k, v, w, u, state, _ = R.wkv_inputs(p0["wkv"], cfg, x, _index(caches, 0))
        views = [a.transpose(1, 2) for a in (r, k, v, w)]
        got = lsops.wkv6(*views, u, state)
        want = ls.wkv6_plain(*views, u, state)
        torch.cuda.synchronize()
        err, tol = wkv_err(got, want)
        if not (err <= tol and all(bool(torch.isfinite(a).all()) for a in got)):
            fail(f"rwkv layer 0 {case}: ops.wkv6 vs plain max err {err:.3e} > {tol:.3e}")
        out[case] = dict(T=tk.shape[1], max_abs_err=err, tolerance=tol)
        print(f"rwkv layer 0 {case} (T={tk.shape[1]}): ops.wkv6 vs plain max |diff| "
              f"{err:.3e} (tol {tol:.3e})", flush=True)
        if case == "prefill":
            model.prefill(params, toks, caches)  # the state the decode step reads
    return out


def rwkv_phase(totals: dict, results: dict) -> dict:
    """Phase 6 of the module docstring."""
    print("-- (a, b) the kernel against its plain version, and its times", flush=True)
    check_wkv6(results)
    cfg = get("rwkv6-1.6b")
    params = rwkv_params(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"-- (c) serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{R.rwkv_head_count(cfg)} heads of {R.HEAD_K}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, {n_params / 1e9:.3f} B parameters", flush=True)
    reqs = rwkv_workload(cfg)
    serve_once(cfg, params, "contiguous", "xla", reqs[:2])  # warm-up, not kept
    runs = []
    for matmul in ("xla", "pallas"):
        calls = HostTimer({"prefill": (Model, "prefill"), "decode": (Model, "decode_step")})
        try:
            res, _, eng = serve_once(cfg, params, "contiguous", matmul, reqs)
        finally:
            calls.restore()
        want = cfg.n_layers * (calls.calls["prefill"] + calls.calls["decode"])
        got = res["launches"]["wkv6"]
        if got != want or got <= 0:
            fail(f"rwkv/{matmul}: wkv6 launched {got} times, want {cfg.n_layers} x "
                 f"({calls.calls['prefill']} prefill calls + {calls.calls['decode']} "
                 f"decode steps) = {want}")
        others = {n: c for n, c in res["launches"].items()
                  if c and n not in ("wkv6", "gemm_bf16")}
        if others or (res["launches"]["gemm_bf16"] > 0) != (matmul == "pallas"):
            fail(f"rwkv/{matmul}: unexpected kernel launches {res['launches']}")
        if eng.stats["admitted"] != len(reqs):
            fail(f"rwkv/{matmul}: admitted {eng.stats['admitted']} of {len(reqs)}")
        print(f"rwkv/{matmul}: wkv6 launched {got} = {cfg.n_layers} x "
              f"({calls.calls['prefill']} prefill calls + {calls.calls['decode']} decode "
              f"steps)", flush=True)
        res.update(prefill_calls=calls.calls["prefill"], decode_steps=calls.calls["decode"])
        runs.append(res)
        for n, c in res["launches"].items():
            totals[n] += c
    print("-- (d) layer 0's real operands", flush=True)
    layer = check_rwkv_layer(cfg, params)
    print("-- (e) where a decode step's time goes", flush=True)
    prof = profile_decode(cfg, params, reqs, focus="wkv6")
    return dict(params=n_params, serve=runs, layer0=layer, decode_profile=prof)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_decode_step(cfg, params) -> float:
    """One full-width decode step through the kernels against the plain
    path (torch.matmul + the masked dense attention) on the same caches."""
    model = build(cfg)
    g = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=g, device=DEV)
    caches = kvcache.build_caches(cfg, 2, 64, DEV)
    model.prefill(params, toks, caches)
    step = torch.randint(0, cfg.vocab, (2, 1), generator=g, device=DEV)
    want, _ = model.decode_step(params, step, {k: v.clone() for k, v in caches.items()})
    got, _ = model.decode_step(params, step, caches,
                               dispatch=L.Dispatch(matmul="pallas", attention="flash"))
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # 32 bf16 layers on both sides, rounded in other places: a few percent
    # of the logit scale
    if not torch.isfinite(got).all() or err > 0.05 * scale:
        fail(f"full-width decode step: kernel path vs plain path max err {err:.3e} "
             f"> 5% of the logit scale {scale:.3e}")
    print(f"decode step (kernels vs plain, full width): max |diff| {err:.3e}, "
          f"logit scale {scale:.3e}", flush=True)
    return err


def main() -> None:
    t_start = time.perf_counter()
    print("== build", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device {name}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print("== kernels against their plain versions", flush=True)
    results: dict = {}
    check_decode(results)
    cfg = get("smollm-360m")
    # the first admission prefills the 8 prefix-sharing prompts, padded to
    # the 16-token bucket above PREFIX + 15, as one batch
    prefill_m = SLOTS * (-(-(PREFIX + 15) // 16) * 16)
    check_gemm(results, prefill_m=prefill_m)
    check_gemm_abft(results, prefill_m=prefill_m)

    print("== serve smollm-360m (full width, random weights)", flush=True)
    params = build(cfg).init(torch.Generator(device=DEV).manual_seed(0), DEV)
    reqs = workload(cfg)
    serve_once(cfg, params, "contiguous", "xla", reqs[:2])  # warm-up, not kept
    runs, tokens = [], {}
    totals = {n: 0 for n in WRAPPERS}
    for matmul in ("xla", "pallas"):
        for layout in ("contiguous", "paged"):
            res, toks, _ = serve_once(cfg, params, layout, matmul, reqs)
            runs.append(res)
            tokens[(layout, matmul)] = toks
            need = ["flash_decode" if layout == "contiguous" else "flash_decode_paged"]
            if matmul == "pallas":
                need.append("gemm_bf16")
            for n in need:
                if res["launches"][n] <= 0:
                    fail(f"{layout}/{matmul}: kernel {n} was never launched on the serve path")
            for n, c in res["launches"].items():
                totals[n] += c
        if tokens[("paged", matmul)] != tokens[("contiguous", matmul)]:
            fail(f"matmul={matmul}: paged tokens differ from contiguous tokens")
        print(f"matmul={matmul}: paged tokens == contiguous tokens", flush=True)

    print("== where a decode step's time goes", flush=True)
    prof = profile_decode(cfg, params, reqs)

    print("== SDC defense (abft), full width, paged KV", flush=True)
    sdc = sdc_phase(cfg, params, reqs, runs[-1], tokens[("paged", "pallas")], totals)

    print("== conv2d on the paper's CNNs (AlexNet, VGG-16, GoogLeNet, batch 16)", flush=True)
    convs = conv_phase(totals, results)

    print("== rwkv6-1.6b (full width, random weights) through the WKV-6 kernel", flush=True)
    rwkv = rwkv_phase(totals, results)

    print("== reference check", flush=True)
    check_decode_step(cfg, params)

    # every reading of this run, in full, beside the built kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, device=name, torch=torch.__version__, kernels=results,
             serve=runs, decode_profile=prof, sdc=sdc, conv=convs, rwkv=rwkv,
             seconds=time.perf_counter() - t_start),
        indent=1))
    kernels = [
        dict(name=n, **KERNEL_INFO[n], launches=totals[n],
             max_abs_err=results[n]["max_abs_err"], ms=results[n]["ms"],
             plain_ms=results[n]["plain_ms"], bound_ms=results[n]["bound_ms"],
             bound_by=results[n]["bound_by"], library_ms=results[n]["library_ms"])
        for n in WRAPPERS
    ]
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
