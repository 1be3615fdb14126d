#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --decode    # the decode-attention checks alone
    python3 chip_smoke.py --conv      # the CONV pass alone (phase 5)
    python3 chip_smoke.py --flash     # flash attention alone (phase 8 (a, b))
    python3 chip_smoke.py --gemm      # the GEMM checks of phase 2 alone
    python3 chip_smoke.py --gemm --baseline OLD/matmul.cu   # ... beside another build
    python3 chip_smoke.py --recur     # WKV-6 and the scan alone (phases 6 (a, b), 7 (a, b))
    python3 chip_smoke.py --recur --baseline OLD/   # ... beside OLD/{linear_scan,wkv6}.cu
    python3 chip_smoke.py --sched     # the scheduler at full width (phase 10)

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
   PyTorch library call, each with a cold L2 (for decode attention also
   the kernel/SDPA ratio, the grid, and each kernel phase's time from the
   blocks' device-clock stamps; the GEMMs' times are medians of 20
   launches, beside each shape's plan -- body, tiles, K split, stages,
   grid -- the kernel/library ratio and the wrapper's host microseconds a
   call);
3. serve full-width smollm-360m (32 layers, random weights from a seeded
   generator) through the port's ``Engine``: 16 requests, half of them
   sharing a 256-token prefix, up to 64 greedy tokens each, in four runs
   (contiguous and paged KV, each with ``matmul="xla"`` and ``"pallas"``).
   Each run's kernel launch counts are set to 0 just before it and read
   just after; paged tokens must equal contiguous tokens; one profiled
   decode step's card busy time and the GEMM kernel's share of it;
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
   ``kernels.conv2d.ops.conv2d``; the stride-1 layers run the CUDA kernel's
   tensor-core body (a TMA ring feeding ``wgmma``) with the tile the
   blocking search picks on ``hw.hopper_levels()`` and ``hw.hopper_array()``
   (the kernel's launch count over the phase must be one per stride-1
   layer), the two strided first layers the plain oracle, as the reference
   routes them.  Each kernel result is held against the plain version and
   a repeat call must be bitwise equal; per distinct shape the search's
   schedule (every level's factors and the array's unrolling) beside the
   kernel tile, its output-tile utilization, ring stages, shared memory and
   grid, the search's seconds, the kernel's median time with a cold L2 (and
   of it the wrapper's padding for TMA where C or K needs it), its TFLOP/s,
   the bound, the plain version's time and cuDNN's (``F.conv2d`` on
   channels_last tensors, TF32 off) are printed;
6. RWKV-6 at full width (rwkv6-1.6b: 24 layers, d_model 2048, 32 WKV
   heads of 64, bf16, random weights from a seeded generator, with a
   seeded data-dependent decay: ``w0`` spread over [-6, -1] and
   ``w_lora_b`` ~ N(0, 1) in place of init's constant decay): (a) the WKV-6
   kernel against its plain version at the decode (8 rows x 32 heads, one
   step) and prefill (1 x 32, 256 steps; and 8 x 32, 256 steps, eight
   prompts in one call) shapes, within 1e-5 of the
   output's and the state's scale, a repeat call bitwise, and at decode
   one row called alone bitwise the same row of the batch; (b) their times
   with a cold L2 and the bound (bytes over 3.35 TB/s or 7 fp32 operations
   per state element and step over the 66.9 TFLOP/s CUDA-core peak), beside
   the kernel's plan (held equal to the kernel's own: vector width, steps
   a thread runs at once, columns a block, grid, ring stage, shared memory)
   and the bytes its resident blocks keep in flight; (c) 16 requests (prompts of
   16-256 tokens, 48-64 greedy new tokens, 8 slots, ``max_len`` 1024)
   served with ``matmul="xla"`` and ``"pallas"``: every request finished,
   the kernel launched exactly 24 times per prefill call and per decode
   step; (d) on layer 0's activations of one prefill and one decode step,
   ``ops.wkv6`` against the plain version; (e) one profiled decode step's
   card busy share and the kernel's share of it;
7. recurrentgemma-2b at full width (26 layers: 8 groups of two RG-LRU
   layers and one attention layer with a 2048-token window, then 2 RG-LRU
   layers; d_model and rnn_width 2560, 10 query heads on 1 KV head of 256,
   d_ff 7680, vocab 256000, bf16, random weights from a seeded generator,
   with a seeded slow decay: ``lam`` drawn in [-9, -2] in place of init's
   [0.9, 4], whose decay forgets everything each step): (a) the linear-scan
   kernel against its plain version and its own repeat, bitwise, at the
   decode (8 x 1 x 2560) and prefill (1 x 2048 x 2560; 1 x 40 x 2560; and
   8 x 200 x 2560, eight prompts in one call) shapes, with its
   plan (body, grid, ring stages and their steps, shared memory, held equal
   to the kernel's own) and bytes in flight, and the decode-attention kernels
   (contiguous and paged) at head_dim 256 with 10 query heads per KV head
   on a 2048-slot ring with six of eight rows wrapped, bitwise; (b) their
   times with a cold L2 beside the bound (bytes over 3.35 TB/s), the plain
   version and one library call (``torch.addcmul`` for one scan step, SDPA
   for attention); (c) 16 requests (two of 1900-2000 prompt tokens and 160
   new tokens, whose rings wrap; fourteen of 16-256 and 48-64) served with
   8 slots at ``max_len`` 4096 with ``matmul="xla"`` and ``"pallas"``:
   every request finished, the scan launched exactly 18 times per prefill
   call and per decode step, decode attention 8 times per decode step;
   (d) on the first RG-LRU layer's operands of one prefill and one decode
   step, ``ops.linear_scan`` against the plain version, bitwise; (e) one
   profiled decode step's card busy share and the two kernels' shares of
   it; (f) one full-width decode step through the kernels against the plain
   path, within 5% of the logit scale;
8. flash attention, and the kernels widened to every dtype and head size
   their Pallas kernels take: (a) the main path, ``ops.flash_attention`` at
   four full-width bf16 shapes -- smollm-360m's prefill (8 x 1024 tokens, 15
   query heads on 5 KV heads of 64, causal), recurrentgemma-2b's attention
   layer (2048 tokens, 10 heads on 1 of 256, window 2048), gemma3-12b's
   local layer (4096 tokens, 16 heads on 8 of 240, window 1024), all the
   static variant, and a smollm chunk of 256 queries at offset 768 over a
   1024-token cache (the dynamic one) -- with the kernel's launch count
   over the phase equal to the calls; (b) each case against the plain
   version, each (b, t, head) row within 1e-2 of its own norm, a repeat
   run bitwise, the kernel's body and plan (tiles, ring stages, shared
   memory), its median time with a cold L2 and TFLOP/s of live pairs
   beside the bound (4 d operations per live (query, key) pair over 989
   TFLOP/s, or the bytes), the plain version's time and SDPA's with the
   same mask, and kernel/SDPA; (c) decode attention at head_dim 16 and 240
   in bf16 (bitwise, paged == contiguous) and in fp32 at smollm-360m's
   shape (within 1e-6 of scale), flash attention in fp32 at smollm-360m's
   prefill shape (each row within 1e-5 of its norm of the plain version,
   beside SDPA in fp32 with TF32 off and the fp32 CUDA-core bound), the
   GEMM and the checksum
   GEMM in fp32 at smollm-360m's decode shapes, one CONV layer in fp32 and
   WKV-6 at key/value head sizes (16, 16) and (32, 64), each against its
   plain version, with its times;
9. check one full-width smollm-360m decode step through the kernels against
   the plain path on the card, then print the ``kernels`` summary and, last,
   the ``{"ok": true, ...}`` line;
10. the serve engine's scheduler at phase 3's widths (run after phase 4; 8
   slots, ``max_len`` 1024, 16-token blocks, the phase-3 weights), held to
   phase 3's uninterrupted ``matmul="pallas"`` tokens as the oracle, each
   run's kernel launches counted as in phase 3 (the decode kernel of its
   layout and, under ``"pallas"``, the GEMM must launch): (a) the phase-3
   workload at priority 0 plus four priority-2 requests submitted after
   step 20, contiguous (every slot busy, so the arrivals preempt) and paged
   (``num_blocks`` just fits the first seven admissions, so a slot is free
   and the arrivals starve for blocks): every original request's tokens
   equal the oracle, at least 4 preemptions, all recovered, with the
   replayed tokens, the steps that re-prefilled or replayed and their share
   of the wall time; then once with ``matmul="xla"`` (cuBLAS projections),
   reporting whether replay held (a divergence raises in the engine and is
   printed); (b) the chunked-prefill lane, ``prefill_chunk`` 256 at
   ``token_budget`` 256 and None, both layouts: tokens equal the oracle,
   ITL p50/p95 and TTFT p50 beside monolithic admission's phase-3 run, and
   the GEMM at the chunk's M = 256 on the five projection shapes as in
   phase 2; (c) four phase-3 requests with ``deadline_steps`` 20 end FAILED,
   each with a prefix of its oracle tokens; (d) ``StaticEngine`` on eight
   128-token prompts: its greedy tokens equal ``Engine``'s, tokens/s of
   both.

``--decode`` runs phase 1 and the decode-attention checks of phases 2, 7 (a)
and 8 (c) (kernel against plain, paged == contiguous, times beside the
bound, the plain version and SDPA), prints their rows as JSON and stops:
no ``ok`` line.  ``--conv`` runs phase 1 and phase 5 the same way,
``--flash`` phase 1 and phase 8 (a, b), ``--gemm`` phase 1 and the GEMM
checks of phase 2, ``--sched`` phase 1, the phase-3 oracle runs phase 10
needs (contiguous ``"xla"`` and ``"pallas"``, paged ``"pallas"``) and phase
10, whose JSON it prints last.  ``--gemm --baseline FILE`` also builds FILE (another
version of ``csrc/matmul.cu`` with the same C entry points, say the
parent commit's) and times it beside this one on the same inputs, in turns
(baseline, this, this, baseline), with the C entry point's host
microseconds a call of each.  ``--recur`` runs phase 1, phase 6 (a, b)
and the scan's part of phase 7 (a, b): per case the kernel's plan (body,
grid, shared memory, bytes in flight), held equal to the kernel's own.
``--recur --baseline DIR`` also builds DIR's ``linear_scan.cu`` and
``wkv6.cu`` (the same C entry points, say the parent commit's) and times
them beside this build's on the same inputs, in turns.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import types
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
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan as ls  # noqa: E402
from repro_torch.kernels.linear_scan import ops as lsops  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm  # noqa: E402
from repro_torch.kernels.matmul import ops as mmops  # noqa: E402
from repro_torch.serve import chaos, kvcache  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, KernelConfig, KVConfig, ReplayDivergedError, Request, SchedulerConfig,
    SDCUnlocalizedError, ServeConfig, StaticEngine,
)

DEV = torch.device("cuda")
WRAPPERS = {
    "flash_decode": dec.flash_decode_cuda,
    "flash_decode_paged": dec.flash_decode_paged_cuda,
    "gemm_bf16": mm.matmul_cuda,
    "gemm_bf16_abft": mm.matmul_abft_cuda,
    "conv2d": conv.conv2d_cuda,
    "wkv6": ls.wkv6_cuda,
    "linear_scan": ls.linear_scan_cuda,
    "flash_attention": fa.flash_attention_cuda,
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
    "linear_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/linear_scan.cu",
        replaces="src/repro/kernels/linear_scan/linear_scan.py:55"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:183"),
}
# the name of every kernel a decode-attention call launches (one:
# csrc/decode_attention.cu's decode_kernel, which splits the KV across a
# cluster and replays the partials in the same launch)
DECODE_KERNEL = "decode_kernel"
# the name of the bf16 GEMM kernel (both bodies, with and without checksums)
GEMM_KERNEL = "gemm_tc_kernel"
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


def median_ms(fn, iters: int = 20) -> float:
    """Median of :func:`time_samples`: one slow launch does not move it."""
    return statistics.median(time_samples(fn, iters))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (enqueue only: no
    synchronisation inside the window), over ``calls`` calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(nbytes: float, flops: float, peak: float = hw.BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate or operations
    over ``peak`` (the bf16 tensor-core rate unless the work is fp32 on the
    CUDA cores), whichever is larger."""
    t_b, t_f = nbytes / hw.HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ----------------------------------------------------------- kernel phase --

DECODE_PHASES = ("scores", "barrier_1", "partials", "barrier_2", "replay")


def decode_phase_us(kern_fn, grid: int) -> dict:
    """One launch of a decode-attention wrapper with ``dec.PHASE_STAMPS``
    set, after the L2 was overwritten: per phase of the kernel the mean and
    the largest time over its blocks (device clock, us), and the span from
    the first block's entry to the last block's exit."""
    stamps = torch.zeros((grid, dec.STAMPS_PER_BLOCK), dtype=torch.int64, device=DEV)
    _flush_buf.zero_()
    dec.PHASE_STAMPS = stamps
    try:
        kern_fn()
        torch.cuda.synchronize()
    finally:
        dec.PHASE_STAMPS = None
    st = stamps.double().cpu() / 1e3
    d = st[:, 1:] - st[:, :-1]
    out = {n: (float(d[:, i].mean()), float(d[:, i].max())) for i, n in enumerate(DECODE_PHASES)}
    out["span"] = float(st[:, -1].max() - st[:, 0].min())
    return out


def check_decode(results: dict, B: int, KV: int, G: int, d: int, S: int, bk: int,
                 lengths: list[int], suffix: str = "", dtype=torch.bfloat16) -> None:
    """Both decode-attention kernels against their plain versions (bf16
    bitwise; fp32 within ``dec.FP32_TOL`` of the output's scale: fp64 sums
    of fp32 products taken in two orders) at one serve path's shape (cache
    extent S, split bk; the paged pool's block is bk); paged must equal
    contiguous bitwise at bk == bs.  The readings go to
    ``results[name + suffix]``."""
    g = torch.Generator(device=DEV).manual_seed(1)
    q = torch.randn((B, KV, G, d), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, KV, d), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, KV, d), generator=g, device=DEV).to(dtype)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    n_blk = S // bk
    perm = torch.randperm(B * n_blk, generator=g, device=DEV) + 1
    tables = perm.reshape(B, n_blk).to(torch.int32)
    kpool = torch.randn((B * n_blk + 1, bk, KV, d), generator=g, device=DEV).to(dtype)
    vpool = torch.randn_like(kpool)
    kpool[tables.long()] = k.reshape(B, n_blk, bk, KV, d)
    vpool[tables.long()] = v.reshape(B, n_blk, bk, KV, d)

    contig = dec.flash_decode_cuda(q, k, v, lengths, bk=bk)
    paged = dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths)
    torch.cuda.synchronize()
    shape = f"B={B} KV={KV} G={G} d={d} S={S} bk=bs={bk} {str(dtype)[6:]}"
    if not torch.equal(contig, paged):
        fail(f"decode attention {shape}: paged differs from contiguous at bk == block_size")
    print(f"decode attention {shape}: paged == contiguous bitwise", flush=True)

    live = torch.clamp(lengths, 1, S).long()
    live_keys = int(live.sum())
    n_live_blocks = int(((live + bk - 1) // bk).sum())
    qo_bytes = 2 * q.numel() * q.element_size() + lengths.numel() * 4
    kv_bytes = live_keys * KV * d * 2 * q.element_size()
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
            contig, lambda: dec.decode_attention_plain(q, k, v, lengths, bk=bk),
            lambda: dec.flash_decode_cuda(q, k, v, lengths, bk=bk), 0,
        ),
        "flash_decode_paged": (
            paged, lambda: dec.decode_attention_paged_plain(q, kpool, vpool, tables, lengths),
            lambda: dec.flash_decode_paged_cuda(q, kpool, vpool, tables, lengths),
            n_live_blocks * 4,
        ),
    }
    fp32 = dtype == torch.float32
    plan = dec.plan(B, KV, G, d, bk, n_blk, q.element_size())
    for name, (got, plain_fn, kern_fn, extra_bytes) in cases.items():
        want = plain_fn()
        err = (got.float() - want.float()).abs()
        # bf16 bitwise: kernel and plain version sum order-independently
        # (fp64 accumulation, one rounding), which the ABFT fingerprint needs
        tol = dec.FP32_TOL * float(want.abs().max()) if fp32 else "bitwise"
        bad = float(err.max()) > tol if fp32 else not torch.equal(got, want)
        if bad:
            fail(f"{name} {shape}: kernel differs from the plain version in "
                 f"{int((got != want).sum())} elements (max |diff| {float(err.max()):.3e}); "
                 f"tolerance {tol}")
        b_ms, b_by = bound_ms(qo_bytes + kv_bytes + extra_bytes, flops,
                              hw.FP32_FLOPS_PER_S if fp32 else hw.BF16_FLOPS_PER_S)
        results[name + suffix] = row = dict(
            max_abs_err=float(err.max()), tolerance=tol,
            ms=time_ms(kern_fn), plain_ms=time_ms(plain_fn, iters=5),
            library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by, shape=f"{shape} live_keys={live_keys}",
            grid=plan.grid(B, KV), cluster=plan.cluster,
            kernels_per_call=dec.KERNELS_PER_CALL,
        )
        row["library_ratio"] = row["ms"] / row["library_ms"]
        row["phase_us"] = ph = decode_phase_us(kern_fn, plan.grid(B, KV))
        print(f"{name} {shape}: max_abs_err={row['max_abs_err']:.3e} "
              f"({tol if isinstance(tol, str) else f'tol {tol:.3e}'}) ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (kernel/SDPA {row['library_ratio']:.2f}x) "
              f"bound_ms={b_ms:.4f} ({b_by}); grid {row['grid']} blocks in clusters of "
              f"{plan.cluster}, {dec.KERNELS_PER_CALL} kernel per call", flush=True)
        print(f"  phases, us (mean / max over blocks): " + ", ".join(
            f"{n} {ph[n][0]:.2f} / {ph[n][1]:.2f}" for n in DECODE_PHASES)
            + f"; first entry to last exit {ph['span']:.2f}", flush=True)


def plan_text(M: int, N: int, K: int, trans_b: bool) -> str:
    p = mm.plan(M, N, K, trans_b)
    return (f"plan {p.body} {p.bm}x{p.bn} split {p.split} stages {p.stages} grid {p.grid} "
            f"smem {p.smem}")


def baseline_library(path: str, sigs: dict | None = None):
    """Build another version of a kernel source (by default
    ``csrc/matmul.cu``; ``sigs`` maps the C entry points to load to their
    ctypes argument types) with the port's nvcc flags into ``build/`` and
    load it."""
    import ctypes
    import hashlib

    sigs = sigs or {fn: mm._SIGS[fn] for fn in ("gemm", "gemm_abft")}
    src = Path(path).resolve()
    h = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = ROOT / "build" / "repro_torch" / f"lib{src.stem}_baseline_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def recur_baselines(directory: str) -> dict:
    """The baseline builds of ``--recur --baseline DIR``: DIR's
    ``linear_scan.cu`` and ``wkv6.cu`` (say the parent commit's), each
    loaded with its C entry point."""
    d = Path(directory)
    return dict(
        linear_scan=baseline_library(
            str(d / "linear_scan.cu"),
            {"linear_scan_fp32": ls._SCAN_SIGS["linear_scan_fp32"]}),
        wkv6=baseline_library(str(d / "wkv6.cu"), {"wkv6_fp32": ls._SIGS["wkv6_fp32"]}),
    )


def in_turns(old_fn, new_fn) -> dict:
    """Mean device ms of a baseline and this build on the same operands, in
    turns (baseline, this, this, baseline)."""
    turns = [time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    return dict(baseline_ms=(turns[0] + turns[3]) / 2, change_ms=(turns[1] + turns[2]) / 2,
                turns_ms=turns)


def against_baseline(base, a, b, trans_b: bool, abft_rows: int = 0) -> dict:
    """The baseline library and this one on the same operands through their
    C entry points: products within one bf16 ulp of each other's scale,
    median device ms in turns (baseline, this, this, baseline) and host us
    a call of each.  ``abft_rows``: the checksum GEMM with that many rows a
    checksum block (else the GEMM)."""
    M, K = a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    new = _build.library("matmul", mm._SIGS)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def call(lib, tag):
        out = outs.setdefault(tag, torch.empty((M, N), dtype=a.dtype, device=DEV))
        if abft_rows:
            chk = outs.setdefault(tag + "_checks", torch.empty(
                (-(-M // abft_rows), N), dtype=torch.float32, device=DEV))
            err = lib.gemm_abft(a.data_ptr(), b.data_ptr(), out.data_ptr(), chk.data_ptr(),
                                M, N, K, int(trans_b), 0, stream)
        else:
            err = lib.gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(trans_b), 0,
                           stream)
        _build.check(err, f"{tag} gemm")

    old_fn, new_fn = (lambda: call(base, "baseline")), (lambda: call(new, "change"))
    old_fn()
    new_fn()
    torch.cuda.synchronize()
    diff = float((outs["baseline"].float() - outs["change"].float()).abs().max())
    scale = float(outs["baseline"].float().abs().max())
    if diff > 2.0**-7 * scale:
        fail(f"gemm {M}x{K}x{N}: this build and the baseline differ by {diff:.3e}")
    turns = [median_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    hosts = [host_us(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    return dict(baseline_ms=(turns[0] + turns[3]) / 2, change_ms=(turns[1] + turns[2]) / 2,
                turns_ms=turns, baseline_host_us=(hosts[0] + hosts[3]) / 2,
                change_host_us=(hosts[1] + hosts[2]) / 2, baseline_max_diff=diff)


def _baseline_text(row: dict) -> str:
    if "baseline_ms" not in row:
        return ""
    return (f"; baseline {row['baseline_ms']:.4f} ms -> {row['change_ms']:.4f} "
            f"(turns {', '.join(f'{t:.4f}' for t in row['turns_ms'])}), C entry host "
            f"{row['baseline_host_us']:.2f} -> {row['change_host_us']:.2f} us")


def gemm_case(M: int, K: int, N: int, trans_b: bool, g, baseline=None) -> dict:
    """The GEMM kernel at one shape against its plain version: the check,
    the shape's plan, median times beside ``torch.matmul`` and the bound,
    and (at the decode M) the wrapper's host microseconds a call."""
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
    del want
    lib = (lambda a=a, b=b: a @ b.T) if trans_b else (lambda a=a, b=b: a @ b)
    kern = lambda a=a, b=b, t=trans_b: mm.matmul_cuda(a, b, trans_b=t)  # noqa: E731
    b_ms, b_by = bound_ms((M * K + K * N + M * N) * 2, 2.0 * M * N * K)
    row = dict(
        M=M, K=K, N=N, trans_b=trans_b, max_abs_err=err, tolerance=tol,
        plan=dataclasses.asdict(mm.plan(M, N, K, trans_b)),
        ms=median_ms(kern),
        plain_ms=median_ms(lambda a=a, b=b, t=trans_b: mm.matmul_plain(a, b, trans_b=t)),
        library_ms=median_ms(lib), bound_ms=b_ms, bound_by=b_by,
        host_us=host_us(kern) if M == SLOTS else None,
    )
    row["ratio"] = row["ms"] / row["library_ms"]
    if baseline is not None:
        row.update(against_baseline(baseline, a, b, trans_b))
    print(f"gemm M={M} K={K} N={N} trans_b={trans_b}: max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} kernel/library {row['ratio']:.2f}x "
          f"bound_ms={b_ms:.4f} ({b_by}); {plan_text(M, N, K, trans_b)}"
          + (f"; wrapper host {row['host_us']:.2f} us a call" if row["host_us"] else "")
          + _baseline_text(row), flush=True)
    return row


def check_gemm(results: dict, prefill_m: int, baseline=None) -> None:
    """The GEMM kernel at the five projection shapes of smollm-360m, at the
    decode M (slots) and a prefill M (:func:`gemm_case` each)."""
    g = torch.Generator(device=DEV).manual_seed(2)
    rows = [gemm_case(M, K, N, trans_b, g, baseline)
            for M in (SLOTS, prefill_m) for K, N, trans_b in GEMM_SHAPES]
    # the summary line carries the sums over one decode step's shapes
    # (M = slots), the case the serve loop runs most
    dec_rows = [r for r in rows if r["M"] == SLOTS]
    pre_rows = [r for r in rows if r["M"] == prefill_m]
    results["gemm_bf16"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in dec_rows), plain_ms=sum(r["plain_ms"] for r in dec_rows),
        library_ms=sum(r["library_ms"] for r in dec_rows),
        bound_ms=sum(r["bound_ms"] for r in dec_rows), bound_by="bytes",
        prefill_ms=sum(r["ms"] for r in pre_rows),
        prefill_library_ms=sum(r["library_ms"] for r in pre_rows),
        shape="sum over the five (K,N) projection shapes at M=8",
        cases=rows,
    )
    print(f"gemm sums: M={SLOTS} {results['gemm_bf16']['ms']:.4f} ms (library "
          f"{results['gemm_bf16']['library_ms']:.4f}); M={prefill_m} "
          f"{results['gemm_bf16']['prefill_ms']:.4f} ms (library "
          f"{results['gemm_bf16']['prefill_library_ms']:.4f})", flush=True)


def check_gemm_abft(results: dict, prefill_m: int, baseline=None) -> None:
    """The checksum GEMM at the five projection shapes, at the decode M of
    the ABFT path (slots + the checksum row), at M = 17 (past the 16-row
    checksum block) and at a prefill M: its product bitwise ``gemm_bf16``'s,
    both outputs the same bits on a second run, the product within one bf16
    ulp of the plain version and the checksums within the ABFT tolerance
    ``ABFT_ATOL + ABFT_RTOL * (e^T|A|)|B|`` of the plain version's (the
    verdict's own bound; both sum fp32 in other orders); then a row's bits
    at every M bucket and across the skinny/wide switch."""
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
            del want, want_checks, scale, bl
            row = dict(M=M, K=K, N=N, trans_b=trans_b, max_abs_err=err, tolerance=tol,
                       checks_max_abs_err=float(c_err.max()),
                       plan=dataclasses.asdict(mm.plan(M, N, K, trans_b)))
            if M in (SLOTS + 1, prefill_m + 1):

                def lib(a=a, b=b, t=trans_b, nrb=nrb, bm=bm, M=M):
                    c = (a @ b.T) if t else (a @ b)
                    pad = torch.nn.functional.pad(c.float(), (0, 0, 0, nrb * bm - M))
                    return c, pad.reshape(nrb, bm, -1).sum(1)

                kern = lambda a=a, b=b, t=trans_b: mm.matmul_abft_cuda(a, b, trans_b=t)  # noqa
                b_ms, b_by = bound_ms((M * K + K * N + M * N) * 2 + nrb * N * 4,
                                      2.0 * M * N * K + M * N)
                row.update(
                    ms=median_ms(kern),
                    plain_ms=median_ms(
                        lambda a=a, b=b, t=trans_b: mm.matmul_abft_plain(a, b, trans_b=t)),
                    library_ms=median_ms(lib), bound_ms=b_ms, bound_by=b_by,
                    gemm_bf16_ms=median_ms(
                        lambda a=a, b=b, t=trans_b: mm.matmul_cuda(a, b, trans_b=t)),
                    host_us=host_us(kern) if M == SLOTS + 1 else None,
                )
                row["ratio"] = row["ms"] / row["library_ms"]
                if baseline is not None and M == SLOTS + 1:
                    row.update(against_baseline(baseline, a, b, trans_b, abft_rows=bm))
            rows.append(row)
            print(f"{case}: max_abs_err={err:.3e} (tol {tol:.3e}) checksum err "
                  f"{row['checks_max_abs_err']:.3e}; {plan_text(M, N, K, trans_b)}" + (
                      f" ms={row['ms']:.4f} (gemm_bf16 {row['gemm_bf16_ms']:.4f}) "
                      f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                      f"kernel/library {row['ratio']:.2f}x "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                      if "ms" in row else "")
                  + (f"; wrapper host {row['host_us']:.2f} us a call" if row.get("host_us")
                     else "") + _baseline_text(row), flush=True)
    # a row's bits do not depend on M, across every M bucket and the
    # skinny (M <= 64) / wide switch, in both layouts of B
    for K, N, trans_b in ((960, 2560, False), (960, 320, True)):
        a = torch.randn((300, K), generator=g, device=DEV).bfloat16()
        b = torch.randn((N, K) if trans_b else (K, N), generator=g, device=DEV).bfloat16()
        full, _ = mm.matmul_abft_cuda(a, b, trans_b=trans_b)
        for M in (1, 8, 9, 16, 17, 40, 64, 65, 128, 129):
            part = a[:M].contiguous()
            if not (torch.equal(mm.matmul_abft_cuda(part, b, trans_b=trans_b)[0], full[:M])
                    and torch.equal(mm.matmul_cuda(part, b, trans_b=trans_b), full[:M])):
                fail(f"gemm_abft K={K} N={N} trans_b={trans_b}: rows changed between M = {M} "
                     f"and M = 300")
    print("gemm_abft: product == gemm_bf16 bitwise, repeat runs bitwise, rows equal at M = "
          "1 ... 300 across every body switch", flush=True)
    dec_rows = [r for r in rows if r["M"] == SLOTS + 1]
    results["gemm_bf16_abft"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in dec_rows), plain_ms=sum(r["plain_ms"] for r in dec_rows),
        library_ms=sum(r["library_ms"] for r in dec_rows),
        bound_ms=sum(r["bound_ms"] for r in dec_rows), bound_by="bytes",
        shape=f"sum over the five (K,N) projection shapes at M={SLOTS + 1}",
        cases=rows,
    )
    print(f"gemm_abft sum at M={SLOTS + 1}: {results['gemm_bf16_abft']['ms']:.4f} ms (library "
          f"pair {results['gemm_bf16_abft']['library_ms']:.4f})", flush=True)


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


def latency(stamps: dict[int, list[float]], t0: float) -> dict:
    """ITL p50/p95 over the gaps between a request's token stamps, and
    TTFT p50 from ``t0``, in ms."""
    itl = sorted(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    ttft = sorted(ts[0] - t0 for ts in stamps.values())

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(len(xs) * p))] * 1e3

    return dict(itl_p50_ms=pct(itl, 0.5), itl_p95_ms=pct(itl, 0.95),
                ttft_p50_ms=pct(ttft, 0.5))


def serve_once(cfg, params, layout: str, matmul: str, reqs: list, abft_mode: str = "off",
               max_len: int = MAX_LEN, decode_block: int | None = BS):
    kv = (KVConfig(layout="paged", block_size=BS) if layout == "paged"
          else KVConfig(decode_block=decode_block))
    scfg = ServeConfig(
        max_len=max_len,
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
    n_tok = sum(len(t) for t in toks)
    res = dict(
        layout=layout, matmul=matmul, abft=abft_mode, tokens=n_tok, wall_s=wall,
        tok_per_s=n_tok / wall, sdc_detected=eng.stats["sdc_detected"],
        **latency(stamps, t0), launches=launches, peak_active=eng.stats["peak_active"],
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


def counted_serve_runs(cfg, params, reqs, per_call: dict, totals: dict, tag: str,
                       **serve_kw) -> tuple[list, Engine]:
    """Serve ``reqs`` on the contiguous layout with ``matmul="xla"`` and
    ``"pallas"``, counting ``Model.prefill`` calls and decode steps.  Each
    kernel named in ``per_call`` must launch exactly (launches per prefill
    call, per decode step) times those counts; no other kernel may launch
    but the GEMM, and it only under ``"pallas"``.  Returns the runs and the
    last engine."""
    runs = []
    for matmul in ("xla", "pallas"):
        calls = HostTimer({"prefill": (Model, "prefill"), "decode": (Model, "decode_step")})
        try:
            res, _, eng = serve_once(cfg, params, "contiguous", matmul, reqs, **serve_kw)
        finally:
            calls.restore()
        n_pre, n_dec = calls.calls["prefill"], calls.calls["decode"]
        got = res["launches"]
        want = {n: a * n_pre + b * n_dec for n, (a, b) in per_call.items()}
        for name, n in want.items():
            if got[name] != n or n <= 0:
                fail(f"{tag}/{matmul}: {name} launched {got[name]} times, want {n} "
                     f"({n_pre} prefill calls, {n_dec} decode steps)")
        others = {n: c for n, c in got.items() if c and n not in want and n != "gemm_bf16"}
        if others or (got["gemm_bf16"] > 0) != (matmul == "pallas"):
            fail(f"{tag}/{matmul}: unexpected kernel launches {got}")
        if eng.stats["admitted"] != len(reqs):
            fail(f"{tag}/{matmul}: admitted {eng.stats['admitted']} of {len(reqs)}")
        print(f"{tag}/{matmul}: " + ", ".join(f"{n} launched {got[n]}" for n in want)
              + f" for {n_pre} prefill calls and {n_dec} decode steps", flush=True)
        res.update(prefill_calls=n_pre, decode_steps=n_dec)
        runs.append(res)
        for n, c in got.items():
            totals[n] += c
    return runs, eng


def profile_decode(cfg, params, reqs, steps: int = 8, layout: str = "contiguous",
                   abft_mode: str = "off", focus: tuple[str, ...] = (),
                   max_len: int = MAX_LEN, decode_block: int | None = BS) -> dict:
    """Where a decode step's time goes on the kernel path
    (``matmul="pallas"``): host wall time per step without the profiler,
    then the card's busy time per step from ``torch.profiler`` (the union
    of the CUDA kernels' intervals) and the kernels that take most of it.
    With ABFT on, also the host time per step inside the attention
    fingerprint, the checked GEMMs (``AbftTrace.mm`` in all), the verdict
    op ``ops.matmul_abft`` and the checksum kernel's wrapper.  With
    ``focus``, also, for each name in it, the card time per step of the
    kernels whose name holds it, and their share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kv = (KVConfig(layout="paged", block_size=BS) if layout == "paged"
          else KVConfig(decode_block=decode_block))
    scfg = ServeConfig(
        max_len=max_len, scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16),
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
    busy_ms = busy / steps / 1e3
    focus_ms = {f: sum(t for n, t in by_name.items() if f in n) / steps / 1e3 for f in focus}
    res = dict(
        layout=layout, abft=abft_mode,
        step_ms=step_ms, device_busy_ms_per_step=busy_ms,
        busy_share=busy_ms / step_ms if spans else None,
        top_kernels_ms_per_step={n[:80]: t / steps / 1e3 for n, t in top},
        host_ms_per_step=host_parts, focus_ms_per_step=focus_ms,
        focus_share_of_busy={f: t / busy_ms if spans else None for f, t in focus_ms.items()},
    )
    print(f"decode step ({cfg.name}, {layout}, pallas, abft={abft_mode}, {SLOTS} live rows): "
          f"{step_ms:.2f} ms wall, card busy {res['device_busy_ms_per_step']:.3f} ms per step "
          f"(share of wall {res['busy_share']})", flush=True)
    for n, t in res["top_kernels_ms_per_step"].items():
        print(f"  {t:.3f} ms/step  {n}")
    for n, t in (host_parts or {}).items():
        print(f"  host {t:.2f} ms/step inside {n}")
    for f, t in focus_ms.items():
        print(f"  {f}: {t:.3f} ms/step of card time, share of busy "
              f"{res['focus_share_of_busy'][f]}", flush=True)
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
    out["profile"] = [profile_decode(cfg, params, reqs, layout="paged", abft_mode=m,
                                     focus=(GEMM_KERNEL,)) for m in ("off", "checksum")]

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


# ------------------------------------------------------- scheduling phase --

SCHED_CHUNK = 256                 # the lane's chunk and token budget, (b)
URGENT_AT, N_URGENT = 20, 4       # priority-2 arrivals after step 20, (a)
DEADLINE_STEPS = 20               # (c)
STATIC_PROMPT, STATIC_NEW = 128, 32   # (d): eight equal prompts


def urgent_requests(cfg, seed: int = 10) -> list:
    """The priority-2 arrivals of (a): prompts of 64-192 tokens, 32 new
    tokens each, ids after the phase-3 workload's."""
    rng = torch.Generator().manual_seed(seed)
    out = []
    for i in range(N_URGENT):
        n = int(torch.randint(64, 193, (1,), generator=rng))
        prompt = torch.randint(0, cfg.vocab, (n,), generator=rng).numpy().astype(np.int32)
        out.append(Request(prompt, max_new=32, request_id=100 + i, priority=2))
    return out


def blocks_to_admit(reqs: list) -> int:
    """Pool blocks, the sink included, that admitting ``reqs`` in order
    takes with prefix sharing: the engine's own host-side commit
    (``_commit_row`` and ``_register_chain``) on a pool that never starves."""
    pool = kvcache.BlockPool(1 << 16, BS)
    host = types.SimpleNamespace(
        pool=pool, scfg=ServeConfig(max_len=MAX_LEN, kv=KVConfig(layout="paged", block_size=BS)))
    for r in reqs:
        info = types.SimpleNamespace(prompt=np.asarray(r.prompt, np.int32), budget=r.max_new)
        Engine._register_chain(host, info, Engine._commit_row(host, info))
    return pool.num_blocks - pool.free_blocks


def prefill_invariance(cfg, params, reqs: list, j: int = 3) -> list[dict]:
    """Whether a prefill row's bits depend on its admission's shape: request
    ``j`` of the 8-prompt admission group ``reqs`` prefilled in the group
    (the bucket of the longest prompt), alone (its own bucket, as a
    preempted request re-prefills) and through the lane (256-token chunks
    from the cache cursor).  Per GEMM route and with the fixed-shape pieces
    on (``q_block``, what the engine runs) and off: whether every layer's
    K and V at the prompt's positions and the first-token logits are the
    same bits, and the first layer whose K differs; and the host wall time
    of the group's prefill call (second of two calls, ending in a sync):
    what the pieces cost an admission."""
    from repro_torch.serve.engine import PREFILL_Q_BLOCK

    model = build(cfg)
    plens = [len(r.prompt) for r in reqs]
    bucket = lambda n: -(-n // 16) * 16  # noqa: E731
    pj = plens[j]

    def prefill(prompts, lpad, d):
        toks = np.zeros((len(prompts), lpad), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        tl = torch.tensor([len(p) - 1 for p in prompts], device=DEV)
        caches = kvcache.build_caches(cfg, len(prompts), MAX_LEN, DEV)
        logits, _ = model.prefill(params, torch.from_numpy(toks).to(DEV), caches,
                                  last_index=tl, dispatch=d)
        return logits, caches

    def lane(prompt, d):
        caches = kvcache.build_caches(cfg, 1, MAX_LEN, DEV)
        for lo in range(0, len(prompt), SCHED_CHUNK):
            part = prompt[lo : lo + SCHED_CHUNK]
            toks = np.zeros((1, SCHED_CHUNK), np.int32)
            toks[0, : len(part)] = part
            li = torch.tensor([len(part) - 1], device=DEV)
            logits, _ = model.prefill(params, torch.from_numpy(toks).to(DEV), caches,
                                      last_index=li, dispatch=d, from_cursor=True)
        return logits, caches

    rows = []
    for matmul in ("pallas", "xla"):
        for qb in (PREFILL_Q_BLOCK, None):
            d = L.Dispatch(matmul=matmul, q_block=qb)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g_logits, g_c = prefill([r.prompt for r in reqs], bucket(max(plens)), d)
                torch.cuda.synchronize()
                group_ms = (time.perf_counter() - t0) * 1e3
            for how, (o_logits, o_c) in (("alone", prefill([reqs[j].prompt], bucket(pj), d)),
                                         ("lane", lane(reqs[j].prompt, d))):
                kk = [torch.equal(g_c["k"][i, j, :pj], o_c["k"][i, 0, :pj])
                      for i in range(cfg.n_layers)]
                vv = [torch.equal(g_c["v"][i, j, :pj], o_c["v"][i, 0, :pj])
                      for i in range(cfg.n_layers)]
                row = dict(matmul=matmul, q_block=qb, against_group=how, group_ms=group_ms,
                           k_equal=all(kk),
                           v_equal=all(vv),
                           logits_equal=torch.equal(g_logits[j], o_logits[0]),
                           logits_max_diff=float((g_logits[j].float()
                                                  - o_logits[0].float()).abs().max()),
                           first_k_layer_differs=next(
                               (i for i, e in enumerate(kk) if not e), None))
                rows.append(row)
                print(f"prefill row bits, matmul={matmul} q_block={qb}, {how} vs the 8-prompt "
                      f"group: K {row['k_equal']}, V {row['v_equal']}, logits "
                      f"{row['logits_equal']} (max diff {row['logits_max_diff']:.3e}), first "
                      f"layer whose K differs {row['first_k_layer_differs']}; the group's "
                      f"prefill {group_ms:.1f} ms", flush=True)
            del g_c
    return rows


def sched_run(cfg, params, reqs: list, tag: str, *, layout: str = "contiguous",
              matmul: str = "pallas", urgent: list = (), num_blocks: int | None = None,
              **sched) -> tuple[dict, list, Engine]:
    """Drive ``reqs`` (and ``urgent`` after step ``URGENT_AT``) through an
    engine step by step with 8 slots at ``max_len`` 1024: the wall time,
    ITL/TTFT, the kernels' launch counts (set to 0 just before, read just
    after), the steps that re-prefilled or replayed a preempted request
    and their share of the wall time."""
    kv = (KVConfig(layout="paged", block_size=BS, num_blocks=num_blocks)
          if layout == "paged" else KVConfig(decode_block=BS))
    scfg = ServeConfig(
        max_len=MAX_LEN,
        scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16, **sched),
        kv=kv, kernel=KernelConfig(matmul=matmul, attention="flash"),
    )
    eng = Engine(cfg, params, scfg, device=DEV)
    stamps: dict[int, list[float]] = {}

    def on_token(rid, tok, idx, done):
        stamps.setdefault(rid, []).append(time.perf_counter())

    for w in WRAPPERS.values():
        w.launches = 0
    at_arrival = None
    replay_steps, replay_s, steps = 0, 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    while True:
        if urgent and eng._step_no == URGENT_AT:
            at_arrival = dict(free_slots=len(eng._free), active=len(eng._slots),
                              free_blocks=None if eng.pool is None else eng.pool.free_blocks)
            for r in urgent:
                eng.submit(r)
        before = (eng.stats["recovered"], eng.stats["replayed"])
        ts = time.perf_counter()
        alive = eng.step(on_token)  # a step ends in the tokens' copy to the host
        dt = time.perf_counter() - ts
        steps += 1
        if (eng.stats["recovered"], eng.stats["replayed"]) != before:
            replay_steps += 1
            replay_s += dt
        if not alive:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    outs = [eng.pop_result(r.request_id) for r in list(reqs) + list(urgent)]
    toks = [o.tolist() for o in outs]
    if not all(0 <= t < cfg.vocab for row in toks for t in row):
        fail(f"{tag}: a token is out of the vocabulary")
    if eng.pool is not None:
        eng.pool.assert_invariants(eng.live_block_refs())
        if eng.pool.free_blocks != eng.pool.num_blocks - 1:
            fail(f"{tag}: blocks leaked after drain")
    need = ["flash_decode_paged" if layout == "paged" else "flash_decode"]
    if matmul == "pallas":
        need.append("gemm_bf16")
    for n in need:
        if launches[n] <= 0:
            fail(f"{tag}: kernel {n} was never launched")
    n_tok = sum(len(t) for t in toks)
    first = {r.request_id for r in reqs}
    res = dict(
        tag=tag, layout=layout, matmul=matmul, num_blocks=num_blocks, **sched,
        tokens=n_tok, steps=steps, wall_s=wall, tok_per_s=n_tok / wall,
        **latency({k: v for k, v in stamps.items() if k in first}, t0),
        statuses=[o.status.value for o in outs], launches=launches,
        peak_active=eng.stats["peak_active"], preempted=eng.stats["preempted"],
        recovered=eng.stats["recovered"], replayed=eng.stats["replayed"],
        replay_steps=replay_steps, replay_s=replay_s, replay_share=replay_s / wall,
        expired=eng.stats["expired"], at_arrival=at_arrival,
    )
    print(f"{tag}: {n_tok} tokens in {steps} steps, {wall:.3f} s = {res['tok_per_s']:.1f} tok/s, "
          f"ITL p50 {res['itl_p50_ms']:.2f} ms p95 {res['itl_p95_ms']:.2f} ms, TTFT p50 "
          f"{res['ttft_p50_ms']:.1f} ms; preempted {res['preempted']}, recovered "
          f"{res['recovered']}, replayed {res['replayed']} tokens in {replay_steps} steps "
          f"({replay_s:.3f} s, {100 * res['replay_share']:.1f}% of the wall)"
          + (f"; at the arrival {at_arrival}" if at_arrival else "")
          + f"; launches {launches}", flush=True)
    return res, toks, eng


def sched_phase(cfg, params, reqs: list, oracle: dict, mono: dict, totals: dict,
                card: str) -> dict:
    """Phase 10, (a)-(d) of the module docstring.  ``oracle`` holds the
    phase-3 tokens and ``mono`` the phase-3 runs by (layout, matmul)."""
    out: dict = {}

    def run(tag, **kw):
        res, toks, eng = sched_run(cfg, params, kw.pop("reqs", reqs), tag, **kw)
        for n, c in res["launches"].items():
            totals[n] += c
        return res, toks, eng

    def finished(res, toks, rs, tag):
        bad = [(r.request_id, st, len(t)) for r, st, t in zip(rs, res["statuses"], toks)
               if st != "FINISHED" or len(t) != r.max_new]
        if bad:
            fail(f"{tag}: requests did not finish their budgets: {bad}")

    print(f"-- (a) preemption: {N_URGENT} priority-2 arrivals after step {URGENT_AT} "
          f"over the phase-3 workload ({card})", flush=True)
    out["prefill_invariance"] = prefill_invariance(cfg, params, reqs[:SLOTS])
    urgent = urgent_requests(cfg)
    nb = blocks_to_admit(reqs[:SLOTS - 1])
    out["preempt"] = []
    for layout in ("contiguous", "paged"):
        tag = f"preempt/{layout}/pallas"
        try:
            res, toks, _ = run(tag, layout=layout, urgent=urgent,
                               num_blocks=nb if layout == "paged" else None)
        except ReplayDivergedError as e:
            fail(f"{tag}: {e}")
        finished(res, toks, list(reqs) + urgent, tag)
        if toks[: len(reqs)] != oracle[(layout, "pallas")]:
            fail(f"{tag}: preempted requests' tokens differ from the uninterrupted run")
        if res["preempted"] < N_URGENT or res["recovered"] != res["preempted"]:
            fail(f"{tag}: preempted {res['preempted']}, recovered {res['recovered']} "
                 f"(want >= {N_URGENT}, all recovered)")
        if layout == "paged" and not res["at_arrival"]["free_slots"]:
            fail(f"{tag}: no slot was free at the arrival, so blocks did not starve it")
        print(f"{tag}: {res['preempted']} preemptions, every original request's tokens "
              f"== the uninterrupted run's", flush=True)
        out["preempt"].append(res)
    # the C1 probe: the same under cuBLAS projections; a divergence raises in
    # the engine and is reported here, not retried
    tag = "preempt/contiguous/xla"
    try:
        res, toks, _ = run(tag, matmul="xla", urgent=urgent)
        held = toks[: len(reqs)] == oracle[("contiguous", "xla")]
        probe = dict(res, held=held, error=None)
    except ReplayDivergedError as e:
        probe = dict(held=False, error=str(e))
    print(f"{tag}: replay held under matmul='xla': {probe['held']}"
          + (f" ({probe['error']})" if probe["error"] else ""), flush=True)
    out["xla_probe"] = probe

    print(f"-- (b) the chunked-prefill lane: prefill_chunk {SCHED_CHUNK}, in turns with "
          f"monolithic admission ({card})", flush=True)
    out["lane"] = []
    for layout in ("contiguous", "paged"):
        p3 = mono[(layout, "pallas")]
        for budget in (SCHED_CHUNK, "mono", None):
            tag = f"lane/{layout}/budget={budget}"
            if budget == "mono":
                tag = f"monolithic/{layout}"
                res, toks, _ = run(tag, layout=layout)
            else:
                res, toks, _ = run(tag, layout=layout, prefill_chunk=SCHED_CHUNK,
                                   token_budget=budget)
            finished(res, toks, reqs, tag)
            if toks != oracle[(layout, "pallas")]:
                fail(f"{tag}: tokens differ from phase 3's monolithic admission")
            print(f"{tag}: tokens == phase 3's; ITL p50/p95 {res['itl_p50_ms']:.2f}/"
                  f"{res['itl_p95_ms']:.2f} ms, TTFT p50 {res['ttft_p50_ms']:.1f} ms (phase 3 "
                  f"monolithic {p3['itl_p50_ms']:.2f}/{p3['itl_p95_ms']:.2f}, "
                  f"{p3['ttft_p50_ms']:.1f})", flush=True)
            out["lane"].append(res)
    g = torch.Generator(device=DEV).manual_seed(7)
    out["gemm_chunk"] = [gemm_case(SCHED_CHUNK, K, N, t, g) for K, N, t in GEMM_SHAPES]

    print(f"-- (c) deadlines: {DEADLINE_STEPS} steps on four phase-3 requests", flush=True)
    dreqs = [dataclasses.replace(r, deadline_steps=DEADLINE_STEPS) for r in reqs[:4]]
    res, toks, _ = run("deadline/contiguous/pallas", reqs=dreqs)
    for r, st, t, want in zip(dreqs, res["statuses"], toks, oracle[("contiguous", "pallas")]):
        if st != "FAILED" or not 1 <= len(t) < r.max_new or t != want[: len(t)]:
            fail(f"deadline: request {r.request_id} ended {st} with {len(t)} tokens, "
                 f"not a FAILED prefix of its uninterrupted tokens")
    print(f"deadline: all four FAILED after {[len(t) for t in toks]} tokens, each a prefix "
          f"of the uninterrupted run", flush=True)
    out["deadline"] = res

    print(f"-- (d) StaticEngine: eight prompts of {STATIC_PROMPT} tokens, {STATIC_NEW} new "
          f"({card})", flush=True)
    rng = torch.Generator().manual_seed(11)
    sreqs = [Request(torch.randint(0, cfg.vocab, (STATIC_PROMPT,), generator=rng).numpy()
                     .astype(np.int32), max_new=STATIC_NEW, request_id=200 + i)
             for i in range(SLOTS)]
    res, toks, _ = run("static-baseline/engine", reqs=sreqs)
    finished(res, toks, sreqs, "static-baseline/engine")
    stat = StaticEngine(cfg, params, ServeConfig(
        max_len=MAX_LEN, scheduler=SchedulerConfig(batch=SLOTS),
        kv=KVConfig(decode_block=BS), kernel=KernelConfig(matmul="pallas")), device=DEV)
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stoks = [o.tolist() for o in stat.generate(sreqs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    for n in ("flash_decode", "gemm_bf16"):
        if launches[n] <= 0:
            fail(f"StaticEngine: kernel {n} was never launched")
    for n, c in launches.items():
        totals[n] += c
    if stoks != toks:
        fail("StaticEngine's greedy tokens differ from Engine's")
    n_tok = sum(len(t) for t in stoks)
    out["static"] = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                         launches=launches, engine_tok_per_s=res["tok_per_s"])
    print(f"StaticEngine: tokens == Engine's; {n_tok / wall:.1f} tok/s against Engine's "
          f"{res['tok_per_s']:.1f} ({card}); launches {launches}", flush=True)
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


def schedule_text(choice) -> str:
    """The search's schedule for one layer: each level's factors (REG, SMEM,
    L2, HBM, the ones above 1) and the array's unrolling."""
    sch = choice.report.schedule
    levels = [f"{lv.name} " + (" ".join(f"{d}{sch.tiling[d][i]}" for d in sch.nest.dims
                                        if sch.tiling[d][i] > 1) or "-")
              for i, lv in enumerate(sch.levels)]
    array = " | ".join(" ".join(f"{d}{f}" for d, f in a) or "-" for a in sch.spatial)
    return f"{' / '.join(levels)}; array {array}"


def conv_phase(totals: dict, results: dict) -> dict:
    """Phase 5 of the module docstring."""
    layers = conv_layers()
    shapes: dict[tuple, dict] = {}
    print("-- tiles from the blocking search on hw.hopper_levels() and hw.hopper_array() "
          "(set-up, outside every timed window)", flush=True)
    for net, name, stride, b in layers:
        key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
        if stride != 1:
            continue
        if key in shapes:
            shapes[key]["layers"].append(f"{net}/{name}")
            continue
        t0 = time.perf_counter()
        choice = convops.conv_search(CONV_BATCH, *key)
        secs = time.perf_counter() - t0
        tiles = choice.tiles
        if convops.choose_conv_blocks(CONV_BATCH, *key) != tiles:
            fail(f"{net}/{name}: the entry point's tile is not the search's")
        X, Y, K = b["X"], b["Y"], b["K"]
        ntiles = tiles.grid(CONV_BATCH, X, Y, K)
        shapes[key] = dict(
            layers=[f"{net}/{name}"], tiles=tiles, search_s=secs, schedule=schedule_text(choice),
            utilization=tiles.utilization(CONV_BATCH, X, Y, K), stages=tiles.stages,
            smem=tiles.ring_bytes(b["FX"], b["FY"]), tiles_n=ntiles,
            blocks=min(ntiles, torch.cuda.get_device_properties(0).multi_processor_count))
        sh = shapes[key]
        print(f"{net}/{name} X=Y={X} C={b['C']} K={K} F={b['FX']}x{b['FY']}: search "
              f"{sh['schedule']} -> tile (nb,bx,by,bc,bk)=({tiles.nb},{tiles.bx},{tiles.by},"
              f"{tiles.bc},{tiles.bk}), utilization {sh['utilization']:.3f}, {tiles.stages} "
              f"stages, smem {sh['smem']} B, {ntiles} tiles on {sh['blocks']} blocks, search "
              f"{secs:.3f} s", flush=True)

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
          "of the element + 1e-3 of the output's max |value|) and a repeat call, bitwise",
          flush=True)
    max_err = 0.0
    for (x, w), out, (net, name, stride, b) in zip(data, outs, layers):
        shape = (CONV_BATCH, b["X"], b["Y"], b["K"])
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"conv {net}/{name}: output {tuple(out.shape)} (want {shape}) or not finite")
        if stride != 1:
            print(f"{net}/{name}: routed to plain (stride {stride})", flush=True)
            continue
        key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
        tiles = shapes[key]["tiles"]
        want = conv.conv2d_plain(x, w, tiles).float()
        err = (out.float() - want).abs()
        # both sum in fp32 in other orders and round once to bf16
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
        tol = ulp + 1e-3 * float(want.abs().max())
        n_bad = int((err > tol).sum())
        if n_bad:
            fail(f"conv {net}/{name}: {n_bad} elements beyond tolerance "
                 f"(max |diff| {float(err.max()):.3e})")
        if not torch.equal(conv.conv2d_cuda(x, w, tiles), out):
            fail(f"conv {net}/{name}: a repeat call is not bitwise equal")
        max_err = max(max_err, float(err.max()))
        print(f"{net}/{name}: max |diff| {float(err.max()):.3e}, within tolerance; repeat "
              f"bitwise", flush=True)
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
        if (b["C"] % 8 or b["C"] < tiles.bc or b["K"] % 8
                or b["K"] < hw.CONV_PANEL):  # the wrapper pads x or w for TMA
            sh["pad_ms"] = statistics.median(
                time_samples(lambda x=x, w=w, t=tiles: conv._pad_for_tma(x, w, t.bc)))
        sh["tflops"] = flops / sh["ms"] / 1e9
        rows.append(dict(shape=dict(X=b["X"], Y=b["Y"], C=b["C"], K=b["K"], FX=b["FX"],
                                    FY=b["FY"]),
                         tiles=dataclasses.asdict(tiles),
                         **{k: v for k, v in sh.items() if k != "tiles"}))
        pad = f" (of it the wrapper's pad for TMA {sh['pad_ms']:.4f})" if "pad_ms" in sh else ""
        print(f"{','.join(sh['layers'])} (X=Y={b['X']} C={b['C']} K={b['K']} "
              f"F={b['FX']}x{b['FY']}): tile ({tiles.nb},{tiles.bx},{tiles.by},{tiles.bc},"
              f"{tiles.bk}) x{tiles.stages}; ms={sh['ms']:.4f}{pad} ({sh['tflops']:.1f} TFLOP/s) "
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
# (B, H, T): a decode step, one 256-token prompt, and eight (the serve
# loop's slots) prefilled in one call
WKV_SHAPES = {"decode": (SLOTS, 32, 1), "prefill": (1, 32, 256),
              "prefill_batch": (SLOTS, 32, 256)}


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


def _turns_text(row: dict) -> str:
    if "baseline_ms" not in row:
        return ""
    return (f"; baseline {row['baseline_ms']:.5f} ms -> {row['change_ms']:.5f} "
            f"(turns {', '.join(f'{t:.5f}' for t in row['turns_ms'])})")


def wkv_plan_row(args, got) -> dict:
    """The WKV-6 kernel's plan for these operands (held equal to the
    kernel's own) and the bytes its resident blocks keep in flight."""
    r, k, v, w, u, s0 = args
    B, H, T, Dk = r.shape
    plan = ls.wkv_plan(B, H, T, Dk, v.shape[3], ls.wkv_vec_ok(r, k, v, w, s0, *got))
    if ls.wkv_kernel_plan(r, k, v, w, s0, *got) != plan.as_ints():
        fail(f"wkv6 ({B}, {H}, {T}): the kernel's plan {ls.wkv_kernel_plan(r, k, v, w, s0, *got)}"
             f" differs from wkv_plan's {plan.as_ints()}")
    return dict(plan=dataclasses.asdict(plan), in_flight_bytes=plan.in_flight(Dk, T))


def wkv_against_baseline(base, args) -> dict:
    """A baseline build's WKV-6 and this one's on the same operands through
    their C entry points: within WKV_TOL of each other's scale, mean device
    ms in turns."""
    r, k, v, w, u, s0 = args
    B, H, T, Dk = r.shape
    new = _build.library("wkv6", ls._SIGS)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def call(lib, tag):
        o, sT = outs.setdefault(tag, (torch.empty_like(v), torch.empty_like(s0)))
        err = lib.wkv6_fp32(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                            u.data_ptr(), s0.data_ptr(), o.data_ptr(), sT.data_ptr(), B, H, T,
                            Dk, v.shape[3], *ls._wkv_strides(r, v), stream)
        _build.check(err, f"{tag} wkv6")

    old_fn, new_fn = (lambda: call(base, "baseline")), (lambda: call(new, "change"))
    old_fn()
    new_fn()
    torch.cuda.synchronize()
    err, tol = wkv_err(outs["change"], outs["baseline"])
    if not err <= tol:
        fail(f"wkv6 ({B}, {H}, {T}): this build and the baseline differ by {err:.3e} > {tol:.3e}")
    return dict(in_turns(old_fn, new_fn), baseline_max_diff=err)


def check_wkv6(results: dict, baseline=None) -> None:
    """(a) and (b) of phase 6: the WKV-6 kernel against its plain version
    at the serve path's decode and prefill shapes (a repeat bitwise, and at
    decode one row alone bitwise the same row in the batch), its plan and
    its times; with ``baseline`` (``recur_baselines``) another build timed
    beside it."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain einsum in full fp32
    g = torch.Generator(device=DEV).manual_seed(8)
    rows = {}
    for case, (B, H, T) in WKV_SHAPES.items():
        args = wkv_inputs(B, H, T, g)
        got = ls.wkv6_cuda(*args)
        again = ls.wkv6_cuda(*args)
        want = ls.wkv6_plain(*args)
        torch.cuda.synchronize()
        err, tol = wkv_err(got, want)
        if not err <= tol:
            fail(f"wkv6 {case} B={B} H={H} T={T}: max err {err:.3e} > {tol:.3e}")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail(f"wkv6 {case}: a repeat call differs")
        if B > 1:
            b, h = B - 3, H // 3
            solo = ls.wkv6_cuda(*(t[b:b + 1, h:h + 1].contiguous() for t in args[:4]),
                                args[4][h:h + 1], args[5][b:b + 1, h:h + 1])
            if not all(torch.equal(p, q[b:b + 1, h:h + 1]) for p, q in zip(solo, got)):
                fail(f"wkv6 {case}: row ({b}, {h}) alone differs from the same row in the batch")
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
            **wkv_plan_row(args, got),
        )
        if baseline is not None:
            row.update(wkv_against_baseline(baseline["wkv6"], args))
        pl = row["plan"]
        print(f"wkv6 {case} B={B} H={H} T={T}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.5f} "
              f"({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP); "
              f"library_ms: none (no single PyTorch call computes the recurrence); "
              f"plan vec {pl['vec']} unroll {pl['unroll']} cols {pl['cols']} grid {pl['grid']} "
              f"x {pl['threads']} chunk {pl['chunk']} "
              f"smem {pl['smem']} in flight {row['in_flight_bytes'] / 1e6:.2f} MB"
              + _turns_text(row), flush=True)
    # the summary line carries the decode shape, the call the serve loop
    # makes most (24 per step); every shape is in build/chip_smoke.json
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
    runs, _ = counted_serve_runs(cfg, params, reqs, {"wkv6": (cfg.n_layers, cfg.n_layers)},
                                 totals, "rwkv")
    print("-- (d) layer 0's real operands", flush=True)
    layer = check_rwkv_layer(cfg, params)
    print("-- (e) where a decode step's time goes", flush=True)
    prof = profile_decode(cfg, params, reqs, focus=("wkv6",))
    return dict(params=n_params, serve=runs, layer0=layer, decode_profile=prof)


# ----------------------------------------------------- recurrentgemma phase --

RG_MAX_LEN = 4096
# (B, T) at D = rnn_width: a decode step, a long prompt, a short one, and
# eight prompts of the serve loop's usual length in one call
SCAN_SHAPES = {"decode": (SLOTS, 1), "prefill": (1, 2048), "prefill_short": (1, 40),
               "prefill_batch": (SLOTS, 200)}


def scan_against_baseline(base, a, x, h0) -> dict:
    """A baseline build's scan and this one's on the same operands through
    their C entry points: bitwise equal, mean device ms in turns."""
    new = _build.library("linear_scan", ls._SCAN_SIGS)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def call(lib, tag):
        o, hT = outs.setdefault(tag, (torch.empty_like(a), torch.empty_like(h0)))
        err = lib.linear_scan_fp32(*ls._scan_args(a, x, h0, o, hT), stream)
        _build.check(err, f"{tag} linear_scan")

    old_fn, new_fn = (lambda: call(base, "baseline")), (lambda: call(new, "change"))
    old_fn()
    new_fn()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(outs["baseline"], outs["change"])):
        fail(f"linear_scan {tuple(a.shape)}: this build and the baseline differ")
    return in_turns(old_fn, new_fn)


def check_linear_scan(results: dict, D: int, baseline=None) -> None:
    """(a) and (b) of phase 7 for the scan: the kernel against its plain
    version, bitwise, at the serve path's decode and prefill shapes (a
    repeat bitwise too), its plan and its times; with ``baseline``
    (``recur_baselines``) another build timed beside it."""
    g = torch.Generator(device=DEV).manual_seed(10)
    rows = {}
    for case, (B, T) in SCAN_SHAPES.items():
        a = torch.rand((B, T, D), generator=g, device=DEV) * 0.998 + 1e-3  # in (0, 1)
        x = torch.randn((B, T, D), generator=g, device=DEV)
        h0 = torch.randn((B, D), generator=g, device=DEV)
        got = ls.linear_scan_cuda(a, x, h0)
        again = ls.linear_scan_cuda(a, x, h0)
        want = ls.linear_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        err = max(float((p - q).abs().max()) for p, q in zip(got, want))
        if not all(torch.equal(p, q) for p, q in zip(got, want)):
            fail(f"linear_scan {case} B={B} T={T} D={D}: kernel differs from the plain "
                 f"version (max |diff| {err:.3e}); they must be bitwise equal")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            fail(f"linear_scan {case}: a repeat call differs")
        plan = ls.scan_plan(B, T, D, *ls.scan_eligibility(a, x, h0, *got))
        if ls.scan_kernel_plan(a, x, h0, *got) != plan.as_ints():
            fail(f"linear_scan {case}: the kernel's plan {ls.scan_kernel_plan(a, x, h0, *got)} "
                 f"differs from scan_plan's {plan.as_ints()}")
        # a and x read once, out written once (12 B per element); h0 read
        # and h_T written once; one multiply and one add per element
        nbytes = 12 * B * T * D + 8 * B * D
        b_ms, b_by = bound_ms(nbytes, 2.0 * B * T * D, hw.FP32_FLOPS_PER_S)
        rows[case] = row = dict(
            B=B, T=T, D=D, max_abs_err=err, tolerance="bitwise",
            ms=time_ms(lambda: ls.linear_scan_cuda(a, x, h0)),
            plain_ms=time_ms(lambda: ls.linear_scan_plain(a, x, h0), iters=5),
            # at T = 1 one call computes the step (out = h_T = x + a * h0)
            library_ms=time_ms(lambda: torch.addcmul(x[:, 0], a[:, 0], h0)) if T == 1 else None,
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            plan=dataclasses.asdict(plan), in_flight_bytes=plan.in_flight(B, T, D),
        )
        if baseline is not None:
            row.update(scan_against_baseline(baseline["linear_scan"], a, x, h0))
        lib = (f"{row['library_ms']:.5f} (torch.addcmul)" if T == 1 else
               "none (no single PyTorch call computes the recurrence)")
        print(f"linear_scan {case} B={B} T={T} D={D}: bitwise ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.5f} ({b_by}, "
              f"{nbytes / 1e6:.2f} MB) library_ms: {lib}; plan {plan.body} grid {plan.grid} x "
              f"{plan.threads} stages {plan.stages} of {plan.steps} steps smem {plan.smem} "
              f"in flight "
              f"{row['in_flight_bytes'] / 1e6:.2f} MB" + _turns_text(row), flush=True)
    # the summary line carries the decode shape, the call the serve loop
    # makes most (18 per step); every shape is in build/chip_smoke.json
    results["linear_scan"] = dict(rows["decode"], shape=f"decode: B={SLOTS} T=1 D={D}",
                                  cases=rows)


def rg_params(cfg) -> dict:
    """Full-width random weights from a seeded generator, with a seeded
    slow RG-LRU decay: init's ``lam`` in [0.9, 4] gives a < 0.01 (the state
    forgets every step), so ``lam`` is drawn in [-9, -2] (a between about
    0.6 and 1), as the CPU tests do in both packages."""
    params = build(cfg).init(torch.Generator(device=DEV).manual_seed(0), DEV)
    g = torch.Generator(device=DEV).manual_seed(1)
    for tree in (params["groups"]["rnn"], params["tail"]):
        if tree:
            tree["rnn"]["lam"].uniform_(-9.0, -2.0, generator=g)
    return params


def rg_workload(cfg, seed: int = 0) -> list:
    """16 requests from a seeded generator: first two with prompts of
    1900-2000 tokens and 160 new tokens (their 2048-slot rings wrap during
    decode), then 14 with prompts of 16-256 tokens and 48-64 new tokens."""
    rng = torch.Generator().manual_seed(seed)
    lens = (torch.randint(1900, 2001, (2,), generator=rng).tolist()
            + torch.randint(16, 257, (14,), generator=rng).tolist())
    budgets = [160, 160] + torch.randint(48, 65, (14,), generator=rng).tolist()
    return [Request(torch.randint(0, cfg.vocab, (n,), generator=rng).numpy().astype(np.int32),
                    max_new=b, request_id=i)
            for i, (n, b) in enumerate(zip(lens, budgets))]


def check_rg_layer(cfg, params) -> dict:
    """(d) of phase 7: ``ops.linear_scan`` against the plain version,
    bitwise, on the operands the first rnn layer hands the scan in a
    1000-token prefill and in the decode step after it (captured from the
    model's own call, before the kernel updates the state in place)."""
    model = build(cfg)
    g = torch.Generator(device=DEV).manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (1, 1000), generator=g, device=DEV)
    step = torch.randint(0, cfg.vocab, (1, 1), generator=g, device=DEV)
    caches = kvcache.build_caches(cfg, 1, RG_MAX_LEN, DEV)
    real = lsops.linear_scan
    out = {}
    for case, run in (("prefill", lambda: model.prefill(params, toks, caches)),
                      ("decode", lambda: model.decode_step(params, step, caches))):
        seen = []

        def capture(a, x, h0, **kw):
            if not seen:
                seen.append((a.clone(), x.clone(), h0.clone()))
            return real(a, x, h0, **kw)

        lsops.linear_scan = capture
        try:
            run()
        finally:
            lsops.linear_scan = real
        a, x, h0 = seen[0]
        got = lsops.linear_scan(a, x, h0)
        want = ls.linear_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        ok = all(torch.equal(p, q) and bool(torch.isfinite(p).all()) for p, q in zip(got, want))
        if not ok:
            fail(f"recurrentgemma layer 0 {case}: ops.linear_scan differs from the plain "
                 f"version on the model's operands")
        out[case] = dict(T=a.shape[1], a_min=float(a.min()), a_max=float(a.max()),
                         h_scale=float(got[1].abs().max()))
        print(f"recurrentgemma layer 0 {case} (T={a.shape[1]}): ops.linear_scan == plain "
              f"bitwise; a in [{out[case]['a_min']:.4f}, {out[case]['a_max']:.4f}], "
              f"|h_T| <= {out[case]['h_scale']:.3e}", flush=True)
    return out


def check_decode_d256(results: dict, cfg) -> None:
    """(a) of phase 7 for decode attention: head_dim 256, 10 query heads on
    one KV head, six of eight rows wrapped (every slot of the 2048-slot ring
    live)."""
    S = cfg.sliding_window
    check_decode(results, SLOTS, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                 cfg.resolved_head_dim, S, attn_ops._pick_decode_bk(S),
                 [37, 1500] + [S] * (SLOTS - 2), suffix="_d256")


def rg_phase(totals: dict, results: dict) -> dict:
    """Phase 7 of the module docstring."""
    cfg = get("recurrentgemma-2b")
    n_rnn = cfg.n_layers - cfg.n_layers // (cfg.rnn_per_attention + 1)
    n_attn = cfg.n_layers - n_rnn
    print("-- (a, b) the kernels against their plain versions, and their times", flush=True)
    check_linear_scan(results, cfg.rnn_width)
    check_decode_d256(results, cfg)
    params = rg_params(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"-- (c) serve {cfg.name}: {cfg.n_layers} layers ({n_rnn} RG-LRU, {n_attn} "
          f"attention with window {cfg.sliding_window}), d_model {cfg.d_model}, rnn_width "
          f"{cfg.rnn_width}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV head of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"{n_params / 1e9:.3f} B parameters; max_len {RG_MAX_LEN}", flush=True)
    reqs = rg_workload(cfg)
    common = dict(max_len=RG_MAX_LEN, decode_block=None)
    serve_once(cfg, params, "contiguous", "xla", reqs[2:4], **common)  # warm-up, not kept
    runs, eng = counted_serve_runs(
        cfg, params, reqs, {"linear_scan": (n_rnn, n_rnn), "flash_decode": (0, n_attn)},
        totals, "recurrentgemma", **common)
    ring = eng.caches["groups"]["attn"]["k"].shape[2]
    print(f"recurrentgemma: the two long requests reached "
          f"{[len(r.prompt) + r.max_new - 1 for r in reqs[:2]]} positions on {ring}-slot "
          f"rings", flush=True)
    if not all(len(r.prompt) + r.max_new - 1 > ring for r in reqs[:2]):
        fail("recurrentgemma: the long requests do not wrap their rings")
    print("-- (d) layer 0's real operands", flush=True)
    layer = check_rg_layer(cfg, params)
    print("-- (e) where a decode step's time goes", flush=True)
    prof = profile_decode(cfg, params, reqs, focus=("linear_scan", DECODE_KERNEL), **common)
    print("-- (f) one full-width decode step, kernels against the plain path", flush=True)
    step_err = check_decode_step(cfg, params)
    return dict(params=n_params, serve=runs, layer0=layer, decode_profile=prof,
                decode_step_max_abs_err=step_err)


# ---------------------------------------------------- flash-attention phase --

FLASH_TOL = 1e-2  # of each (b, t, head) row's norm (bf16 p and output)
FLASH_F32_TOL = 1e-5  # the same in fp32 (sums in another order)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ||got - want|| / ||want|| over the rows of the last
    dimension.  Each row is held to its own scale: a late query row that
    averages hundreds of keys is ~20x smaller than an early one, so one
    scale for the whole tensor would hide a dropped or misplaced key tile."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def flash_cases() -> list[tuple]:
    """(name, B, Tq, Tk, KV, G, d, kwargs) at the served models' published
    head shapes: smollm-360m's prefill of 8 prompts of 1024 tokens,
    recurrentgemma-2b's attention layer over a 2048-token prompt (its window
    is 2048), gemma3-12b's local layer over 4096 tokens (window 1024), and a
    smollm chunk of 256 queries at offset 768 over a 1024-token cache."""
    out = []
    for name, arch, B, T, kw in (
        ("smollm-360m prefill", "smollm-360m", 8, 1024, {}),
        ("recurrentgemma-2b attention prefill", "recurrentgemma-2b", 1, 2048, None),
        ("gemma3-12b local layer", "gemma3-12b", 1, 4096, None),
        ("smollm-360m chunk", "smollm-360m", 8, 1024, dict(q_offset=768, kv_len=1024)),
    ):
        cfg = get(arch)
        kw = dict(window=cfg.sliding_window) if kw is None else kw
        Tq = T - kw.get("q_offset", 0)
        out.append((name, B, Tq, T, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                    cfg.resolved_head_dim, kw))
    return out


def flash_live(Tq: int, Tk: int, kw: dict):
    """The (Tq, Tk) mask of live (query, key) pairs of one head, as the
    kernel masks them (causal, the window, keys below kv_len)."""
    q_pos = kw.get("q_offset", 0) + torch.arange(Tq, device=DEV)[:, None]
    k_pos = torch.arange(Tk, device=DEV)[None, :]
    ok = (k_pos < min(kw.get("kv_len", Tk), Tk)) & (q_pos >= k_pos)
    if kw.get("window") is not None:
        ok &= q_pos - k_pos < kw["window"]
    return ok


def flash_phase(totals: dict, results: dict) -> None:
    """Phase 8 (a, b) of the module docstring."""
    cases = flash_cases()
    g = torch.Generator(device=DEV).manual_seed(13)
    data = [tuple(torch.randn(s, generator=g, device=DEV).bfloat16()
                  for s in ((B, Tq, KV, G, d), (B, Tk, KV, d), (B, Tk, KV, d)))
            for _, B, Tq, Tk, KV, G, d, _ in cases]

    print("-- the main path: ops.flash_attention at the four full-width shapes", flush=True)
    for wr in WRAPPERS.values():
        wr.launches = 0
    torch.cuda.synchronize()
    outs = [attn_ops.flash_attention(q, k, v, **c[7]) for (q, k, v), c in zip(data, cases)]
    torch.cuda.synchronize()
    launches = {n: wr.launches for n, wr in WRAPPERS.items()}
    if launches["flash_attention"] != len(cases):
        fail(f"flash_attention: {launches['flash_attention']} kernel launches over "
             f"{len(cases)} calls")
    if any(c for n, c in launches.items() if n != "flash_attention"):
        fail(f"flash phase launched other kernels: {launches}")
    totals["flash_attention"] += launches["flash_attention"]
    print(f"flash_attention launched {launches['flash_attention']} times over "
          f"{len(cases)} calls", flush=True)

    print(f"-- each case against the plain version (each (b, t, head) row within "
          f"{FLASH_TOL} of its own norm), repeat runs bitwise; times with a cold L2 "
          f"(kernel and SDPA: median of 20; plain: mean of 3)", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for (q, k, v), out, (name, B, Tq, Tk, KV, G, d, kw) in zip(data, outs, cases):
        shape = " ".join([f"B={B} Tq={Tq} Tk={Tk} heads {KV * G} on {KV} d={d}"]
                         + [f"{a}={b}" for a, b in kw.items()])
        again = attn_ops.flash_attention(q, k, v, **kw)
        want = attn_ops.flash_attention(q, k, v, impl="plain", **kw)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        rel = row_rel_err(out, want)
        if not (rel <= FLASH_TOL and torch.equal(out, again)
                and bool(torch.isfinite(out).all())):
            fail(f"flash_attention {name} ({shape}): row error {rel:.3e} of the row's norm "
                 f"(tol {FLASH_TOL}), max abs err {err:.3e}, repeat bitwise "
                 f"{torch.equal(out, again)}")
        ok = flash_live(Tq, Tk, kw)
        live_pairs = int(ok.sum()) * B * KV * G
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(nbytes, 4.0 * d * live_pairs)
        # the yardstick: SDPA on (B, H, T, d) copies, GQA inside, the same mask
        qh = q.reshape(B, Tq, KV * G, d).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        causal = Tq == Tk and bool(torch.equal(ok, torch.ones_like(ok).tril()))
        mask = None if causal else ok

        def lib(qh=qh, kh=kh, vh=vh, mask=mask, causal=causal):
            return sdpa(qh, kh, vh, attn_mask=mask, is_causal=causal, enable_gqa=True)

        lib_out = lib().transpose(1, 2).reshape(q.shape)
        lib_err = float((lib_out.float() - want.float()).abs().max())
        lib_rel = row_rel_err(lib_out, want)
        del lib_out
        pl = fa.plan(d)
        row = dict(
            case=name, shape=shape, body=fa.body(d, q.dtype), plan=dataclasses.asdict(pl),
            live_pairs=live_pairs, max_abs_err=err,
            max_row_rel_err=rel, row_rel_tolerance=FLASH_TOL,
            ms=statistics.median(time_samples(lambda q=q, k=k, v=v, kw=kw:
                                              attn_ops.flash_attention(q, k, v, **kw))),
            plain_ms=time_ms(lambda q=q, k=k, v=v, kw=kw:
                             attn_ops.flash_attention(q, k, v, impl="plain", **kw), iters=3),
            library_ms=statistics.median(time_samples(lib)), library_max_abs_err=lib_err,
            library_row_rel_err=lib_rel,
            bound_ms=b_ms, bound_by=b_by, flops=4.0 * d * live_pairs, bytes=nbytes,
        )
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        print(f"flash_attention {name} ({shape}): body {row['body']}, plan bq={pl.bq} "
              f"bkv={pl.bkv} stages={pl.stages} smem={pl.smem} B; max_abs_err={err:.3e} "
              f"row error {rel:.3e} of its norm (tol {FLASH_TOL}), repeat bitwise; "
              f"ms={row['ms']:.4f} ({row['tflops']:.1f} TFLOP/s, "
              f"{row['kernel_over_library']:.2f}x SDPA) bound_ms={b_ms:.4f} "
              f"({b_by}, {row['flops'] / 1e9:.1f} GFLOP of {live_pairs} live pairs) plain_ms={row['plain_ms']:.3f} "
              f"library_ms={row['library_ms']:.4f} (SDPA, {'causal' if causal else 'mask'}; "
              f"|SDPA - plain| {lib_err:.3e}, row error {lib_rel:.3e})", flush=True)
    del data, outs

    def total(key):
        return sum(r[key] for r in rows)

    by_flops = total("flops") / hw.BF16_FLOPS_PER_S >= total("bytes") / hw.HBM_BYTES_PER_S
    results["flash_attention"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=total("ms"),
        plain_ms=total("plain_ms"), library_ms=total("library_ms"),
        bound_ms=total("bound_ms"), bound_by="operations" if by_flops else "bytes",
        shape="sum over the four full-width cases, bf16", cases=rows,
    )


def check_decode_widened(results: dict) -> None:
    """Phase 8 (c) for decode attention: head_dim 16 and 240 in bf16,
    smollm-360m's shape in fp32."""
    lengths = [0, 1, 17, 100, 255, 300, 777, 1024]
    print("-- decode attention at the -smoke head_dim 16 (4 heads on 2) and gemma3-12b's "
          "240 (16 on 8, a 1024-slot window ring, bk 64), bf16; smollm-360m's shape in "
          "fp32", flush=True)
    check_decode(results, SLOTS, 2, 2, 16, MAX_LEN, BS, lengths, suffix="_d16")
    cfg = get("gemma3-12b")
    check_decode(results, SLOTS, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                 cfg.resolved_head_dim, cfg.sliding_window,
                 attn_ops._pick_decode_bk(cfg.sliding_window), lengths, suffix="_d240")
    check_decode(results, SLOTS, 5, 3, 64, MAX_LEN, BS, lengths, suffix="_fp32",
                 dtype=torch.float32)


def check_flash_fp32(results: dict) -> None:
    """Phase 8 (c) for flash attention: the fp32 body at smollm-360m's
    prefill shape, against its plain version and SDPA in fp32."""
    name, B, Tq, Tk, KV, G, d, kw = flash_cases()[0]
    print(f"-- flash attention in fp32 at {name} (each row within {FLASH_F32_TOL} of its "
          f"norm; SDPA in fp32, TF32 off)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(15)
    q, k, v = (torch.randn(s, generator=g, device=DEV)
               for s in ((B, Tq, KV, G, d), (B, Tk, KV, d), (B, Tk, KV, d)))
    got = attn_ops.flash_attention(q, k, v, **kw)
    again = attn_ops.flash_attention(q, k, v, **kw)
    want = attn_ops.flash_attention(q, k, v, impl="plain", **kw)
    torch.cuda.synchronize()
    rel = row_rel_err(got, want)
    if not (rel <= FLASH_F32_TOL and torch.equal(got, again)):
        fail(f"fp32 flash_attention {name}: row error {rel:.3e} (tol {FLASH_F32_TOL}), "
             f"repeat bitwise {torch.equal(got, again)}")
    live_pairs = int(flash_live(Tq, Tk, kw).sum()) * B * KV * G
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(nbytes, 4.0 * d * live_pairs, hw.FP32_FLOPS_PER_S)
    qh = q.reshape(B, Tq, KV * G, d).transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                                enable_gqa=True)

    lib_rel = row_rel_err(lib().transpose(1, 2).reshape(q.shape), want)
    results["flash_attention_fp32"] = row = dict(
        case=name, body=fa.body(d, q.dtype), max_abs_err=float((got - want).abs().max()),
        max_row_rel_err=rel, row_rel_tolerance=FLASH_F32_TOL,
        ms=statistics.median(time_samples(lambda: attn_ops.flash_attention(q, k, v, **kw))),
        plain_ms=time_ms(lambda: attn_ops.flash_attention(q, k, v, impl="plain", **kw),
                         iters=3),
        library_ms=statistics.median(time_samples(lib)), library_row_rel_err=lib_rel,
        bound_ms=b_ms, bound_by=b_by, flops=4.0 * d * live_pairs)
    print(f"fp32 flash_attention {name}: body {row['body']}, row error {rel:.3e} (tol "
          f"{FLASH_F32_TOL}), repeat bitwise; ms={row['ms']:.4f} "
          f"({row['flops'] / row['ms'] / 1e9:.1f} TFLOP/s) plain_ms={row['plain_ms']:.3f} "
          f"library_ms={row['library_ms']:.4f} (SDPA fp32, {row['ms'] / row['library_ms']:.2f}x; "
          f"row error {lib_rel:.3e}) bound_ms={b_ms:.4f} ({b_by})", flush=True)


def check_widened(results: dict) -> None:
    """Phase 8 (c): each widened kernel at the dtypes and sizes it took on
    in this slice, against its plain version, with its times."""
    check_decode_widened(results)
    check_flash_fp32(results)

    print("-- the GEMM and the checksum GEMM in fp32 at smollm-360m's five projection "
          "shapes, M = 8 (within 1e-5 of the output's scale; the checksum GEMM's product "
          "bitwise the GEMM's)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # torch.matmul in full fp32
    g = torch.Generator(device=DEV).manual_seed(14)
    rows = []
    for K, N, trans_b in GEMM_SHAPES:
        a = torch.randn((SLOTS, K), generator=g, device=DEV)
        b = torch.randn((N, K) if trans_b else (K, N), generator=g, device=DEV)
        got = mm.matmul_cuda(a, b, trans_b=trans_b)
        prod, checks = mm.matmul_abft_cuda(a, b, trans_b=trans_b)
        want, want_checks = mm.matmul_abft_plain(a, b, trans_b=trans_b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        c_err = float((checks - want_checks).abs().max())
        if not (err <= tol and torch.equal(prod, got)
                and not bool(mmops.matmul_abft(a, b, trans_b=trans_b)[1])):
            fail(f"fp32 gemm {SLOTS}x{K}x{N}: err {err:.3e} (tol {tol:.3e}), checksum GEMM "
                 f"product bitwise {torch.equal(prod, got)}")
        lib = (lambda a=a, b=b: a @ b.T) if trans_b else (lambda a=a, b=b: a @ b)
        b_ms, b_by = bound_ms(4 * (SLOTS * K + K * N + SLOTS * N), 2.0 * SLOTS * N * K,
                              hw.FP32_FLOPS_PER_S)
        row = dict(
            M=SLOTS, K=K, N=N, trans_b=trans_b, max_abs_err=err, tolerance=tol,
            checks_max_abs_err=c_err,
            ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_cuda(a, b, trans_b=t)),
            abft_ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_abft_cuda(a, b, trans_b=t)),
            plain_ms=time_ms(lambda a=a, b=b, t=trans_b: mm.matmul_plain(a, b, trans_b=t)),
            library_ms=time_ms(lib), bound_ms=b_ms, bound_by=b_by,
        )
        rows.append(row)
        print(f"fp32 gemm M={SLOTS} K={K} N={N} trans_b={trans_b}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}) checksum err {c_err:.3e} ms={row['ms']:.4f} "
              f"abft_ms={row['abft_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
    results["gemm_fp32"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        **{k: sum(r[k] for r in rows) for k in ("ms", "abft_ms", "plain_ms", "library_ms",
                                                "bound_ms")},
        bound_by="bytes", shape=f"sum over the five (K,N) projection shapes at M={SLOTS}, fp32",
        cases=rows)

    print("-- conv2d in fp32: AlexNet conv3 (13 x 13, C 256, K 384, 3 x 3) at batch 16, "
          "tile searched in 4-byte words (within 1e-5 of the element + 1e-5 of the scale)",
          flush=True)
    X, C, K, F = 13, 256, 384, 3
    x = torch.randn((CONV_BATCH, X + F - 1, X + F - 1, C), generator=g, device=DEV)
    w = torch.randn((F, F, C, K), generator=g, device=DEV) * 0.05
    tiles = convops.choose_conv_blocks(CONV_BATCH, X, X, C, K, F, F, word_bytes=4)
    got = conv.conv2d_cuda(x, w, tiles)
    want = conv.conv2d_plain(x, w, tiles)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if bool((err > 1e-5 * want.abs() + 1e-5 * want.abs().max()).any()):
        fail(f"fp32 conv2d: max |diff| {float(err.max()):.3e} beyond tolerance")
    torch.backends.cudnn.allow_tf32 = False
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2.0 * CONV_BATCH * X * X * C * K * F * F
    b_ms, b_by = bound_ms(4 * (x.numel() + w.numel() + got.numel()), flops,
                          hw.FP32_FLOPS_PER_S)
    results["conv2d_fp32"] = row = dict(
        tiles=dataclasses.asdict(tiles), smem=tiles.smem_bytes(F, F, 4),
        max_abs_err=float(err.max()),
        ms=statistics.median(time_samples(lambda: conv.conv2d_cuda(x, w, tiles))),
        plain_ms=time_ms(lambda: conv.conv2d_plain(x, w, tiles), iters=3),
        library_ms=statistics.median(
            time_samples(lambda: torch.nn.functional.conv2d(xn, wn))),
        bound_ms=b_ms, bound_by=b_by, shape=f"B={CONV_BATCH} X=Y={X} C={C} K={K} F={F}x{F}")
    print(f"fp32 conv2d tile ({tiles.bx},{tiles.by},{tiles.bc},{tiles.bk}), smem "
          f"{row['smem']} B: max |diff| {row['max_abs_err']:.3e} ms={row['ms']:.4f} "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s) plain_ms={row['plain_ms']:.3f} "
          f"library_ms={row['library_ms']:.4f} (cuDNN fp32, TF32 off) bound_ms={b_ms:.4f} "
          f"({b_by})", flush=True)

    print("-- WKV-6 at key/value head sizes (16, 16) and (32, 64), (B, H, T) = (1, 32, 256) "
          f"(within {WKV_TOL} of scale)", flush=True)
    for Dk, Dv in ((16, 16), (32, 64)):
        B, H, T = 1, 32, 256

        def stream(D):
            return torch.randn((B, T, H, D), generator=g, device=DEV).transpose(1, 2)

        args = (stream(Dk), stream(Dk), stream(Dv), torch.exp(-torch.exp(stream(Dk) - 1.0)),
                0.5 * torch.randn((H, Dk), generator=g, device=DEV),
                torch.randn((B, H, Dk, Dv), generator=g, device=DEV))
        got = ls.wkv6_cuda(*args)
        want = ls.wkv6_plain(*args)
        torch.cuda.synchronize()
        err, tol = wkv_err(got, want)
        if not err <= tol:
            fail(f"wkv6 Dk={Dk} Dv={Dv}: max err {err:.3e} > {tol:.3e}")
        nbytes = 4 * (B * H * T * (3 * Dk + 2 * Dv) + H * Dk + 2 * B * H * Dk * Dv)
        b_ms, b_by = bound_ms(nbytes, 7.0 * B * H * T * Dk * Dv, hw.FP32_FLOPS_PER_S)
        key = f"wkv6_{Dk}x{Dv}"
        results[key] = row = dict(
            B=B, H=H, T=T, Dk=Dk, Dv=Dv, max_abs_err=err, tolerance=tol,
            ms=time_ms(lambda a=args: ls.wkv6_cuda(*a)),
            plain_ms=time_ms(lambda a=args: ls.wkv6_plain(*a), iters=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(f"wkv6 Dk={Dk} Dv={Dv} B={B} H={H} T={T}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} bound_ms={b_ms:.5f} "
              f"({b_by})", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_decode_step(cfg, params) -> float:
    """One full-width decode step through the kernels against the plain
    path (torch.matmul + the masked dense attention) on the same caches.
    The linear scan has no plain route on the card: both paths run its
    kernel, which (d) of phase 7 holds bitwise to its plain version."""
    model = build(cfg)
    g = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 48), generator=g, device=DEV)
    caches = kvcache.build_caches(cfg, 2, 64, DEV)
    model.prefill(params, toks, caches)
    step = torch.randint(0, cfg.vocab, (2, 1), generator=g, device=DEV)
    want, _ = model.decode_step(params, step, kvcache._tree_map(torch.clone, caches))
    got, _ = model.decode_step(params, step, caches,
                               dispatch=L.Dispatch(matmul="pallas", attention="flash"))
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    # all bf16 layers on both sides, rounded in other places: a few percent
    # of the logit scale
    if not torch.isfinite(got).all() or err > 0.05 * scale:
        fail(f"full-width {cfg.name} decode step: kernel path vs plain path max err "
             f"{err:.3e} > 5% of the logit scale {scale:.3e}")
    print(f"decode step ({cfg.name}, kernels vs plain, full width): max |diff| {err:.3e}, "
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

    results: dict = {}
    if sys.argv[1:] == ["--conv"]:
        # the CONV pass alone: phase 5
        print("== conv2d on the paper's CNNs (AlexNet, VGG-16, GoogLeNet, batch 16)", flush=True)
        convs = conv_phase({n: 0 for n in WRAPPERS}, results)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"conv": {"pass": results["conv2d"], **convs}}))
        return
    if sys.argv[1:2] == ["--recur"]:
        # the two recurrences alone: phase 6 (a, b) and the scan of phase 7
        # (a, b), optionally beside a baseline build
        base = None
        if sys.argv[2:3] == ["--baseline"] and len(sys.argv) == 4:
            base = recur_baselines(sys.argv[3])
        elif len(sys.argv) != 2:
            fail("usage: chip_smoke.py --recur [--baseline DIR]")
        print("== WKV-6 at rwkv6-1.6b's shapes, the scan at recurrentgemma-2b's", flush=True)
        check_wkv6(results, base)
        check_linear_scan(results, get("recurrentgemma-2b").rnn_width, base)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"recur": {k: results[k] for k in ("wkv6", "linear_scan")}}))
        return
    if sys.argv[1:] == ["--flash"]:
        # flash attention alone: phase 8 (a, b)
        print("== flash attention at full width", flush=True)
        totals = {n: 0 for n in WRAPPERS}
        flash_phase(totals, results)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"flash": results["flash_attention"]}))
        return
    # the first admission prefills the 8 prefix-sharing prompts, padded to
    # the 16-token bucket above PREFIX + 15, as one batch
    prefill_m = SLOTS * (-(-(PREFIX + 15) // 16) * 16)
    if sys.argv[1:2] == ["--gemm"]:
        # the GEMM checks of phase 2 alone, optionally beside a baseline build
        base = None
        if sys.argv[2:3] == ["--baseline"] and len(sys.argv) == 4:
            base = baseline_library(sys.argv[3])
        elif len(sys.argv) != 2:
            fail("usage: chip_smoke.py --gemm [--baseline FILE]")
        print("== the GEMM and the checksum GEMM at smollm-360m's shapes", flush=True)
        check_gemm(results, prefill_m, base)
        check_gemm_abft(results, prefill_m, base)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"gemm": {k: results[k] for k in ("gemm_bf16", "gemm_bf16_abft")}}))
        return
    sched_only = sys.argv[1:] == ["--sched"]
    if not sched_only:
        print("== kernels against their plain versions", flush=True)
        check_decode(results, SLOTS, 5, 3, 64, MAX_LEN, BS,
                     [0, 1, 17, 100, 255, 300, 777, 1024])
    if sys.argv[1:] == ["--decode"]:
        # decode attention alone: phase 2's shape, 7 (a)'s and 8 (c)'s
        check_decode_d256(results, get("recurrentgemma-2b"))
        check_decode_widened(results)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"decode": results}))
        return
    cfg = get("smollm-360m")
    if not sched_only:
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
            if sched_only and (layout, matmul) == ("paged", "xla"):
                continue  # --sched needs the oracles of phase 10 alone
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
        if ("paged", matmul) in tokens:
            if tokens[("paged", matmul)] != tokens[("contiguous", matmul)]:
                fail(f"matmul={matmul}: paged tokens differ from contiguous tokens")
            print(f"matmul={matmul}: paged tokens == contiguous tokens", flush=True)
    mono = {(r["layout"], r["matmul"]): r for r in runs}
    if sched_only:
        print("== scheduling at full width", flush=True)
        sched = sched_phase(cfg, params, reqs, tokens, mono, totals, card)
        print(f"done in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"sched": sched, "launches": totals}))
        return

    print("== where a decode step's time goes", flush=True)
    prof = profile_decode(cfg, params, reqs, focus=(GEMM_KERNEL,))

    print("== SDC defense (abft), full width, paged KV", flush=True)
    sdc = sdc_phase(cfg, params, reqs, runs[-1], tokens[("paged", "pallas")], totals)

    print("== scheduling at full width", flush=True)
    sched = sched_phase(cfg, params, reqs, tokens, mono, totals, card)

    print("== conv2d on the paper's CNNs (AlexNet, VGG-16, GoogLeNet, batch 16)", flush=True)
    convs = conv_phase(totals, results)

    print("== rwkv6-1.6b (full width, random weights) through the WKV-6 kernel", flush=True)
    rwkv = rwkv_phase(totals, results)

    print("== recurrentgemma-2b (full width, random weights) through the linear-scan and "
          "decode-attention kernels", flush=True)
    rgemma = rg_phase(totals, results)

    print("== flash attention at full width, and the kernels widened to every dtype and "
          "head size their Pallas kernels take", flush=True)
    flash_phase(totals, results)
    check_widened(results)

    print("== reference check", flush=True)
    check_decode_step(cfg, params)

    # every reading of this run, in full, beside the built kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, device=name, torch=torch.__version__, kernels=results,
             serve=runs, decode_profile=prof, sdc=sdc, sched=sched, conv=convs, rwkv=rwkv,
             recurrentgemma=rgemma,
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
