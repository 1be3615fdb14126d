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
4. check one full-width decode step through the kernels against the plain
   path on the card, then print the ``kernels`` summary and, last, the
   ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
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

from repro_torch.arch.model_zoo import build  # noqa: E402
from repro_torch.arch import layers as L  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import decode_attention as dec  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm  # noqa: E402
from repro_torch.serve import kvcache  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine, KernelConfig, KVConfig, Request, SchedulerConfig, ServeConfig,
)

DEV = torch.device("cuda")
WRAPPERS = {
    "flash_decode": dec.flash_decode_cuda,
    "flash_decode_paged": dec.flash_decode_paged_cuda,
    "gemm_bf16": mm.matmul_cuda,
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
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing --

_flush_buf = None


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after the
    L2 cache was overwritten (the serve path finds its weights and KV
    cold: a decode step streams far more than 50 MB).  A spin kernel
    before the start event keeps the card busy while the host enqueues
    ``fn``, so the host's launch overhead stays out of the reading."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(iters):
        _flush_buf.zero_()
        torch.cuda._sleep(1_000_000)  # about half a millisecond of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
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
        # two bf16 ulps at unit scale: both sides sum in fp32 and round
        # once; they differ in summation order and exp
        tol = 2e-2 + 2e-2 * want.float().abs()
        if not bool((err <= tol).all()):
            fail(f"{name}: max |kernel - plain| = {float(err.max()):.3e} exceeds "
                 f"2e-2 + 2e-2*|plain|")
        b_ms, b_by = bound_ms(qo_bytes + kv_bytes + extra_bytes, flops)
        results[name] = dict(
            max_abs_err=float(err.max()), tolerance="2e-2 + 2e-2*|plain|",
            ms=time_ms(kern_fn), plain_ms=time_ms(plain_fn, iters=5),
            library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} KV={KV} G={G} d={d} S={S} bs={BS} live_keys={live_keys}",
        )
        print(f"{name}: max_abs_err={results[name]['max_abs_err']:.3e} "
              f"(tol 2e-2 + 2e-2*|plain|) ms={results[name]['ms']:.4f} "
              f"plain_ms={results[name]['plain_ms']:.4f} "
              f"library_ms={results[name]['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)


def check_gemm(results: dict, prefill_m: int) -> None:
    """The GEMM kernel at the five projection shapes of smollm-360m, at the
    decode M (slots) and a prefill M, against its plain version."""
    g = torch.Generator(device=DEV).manual_seed(2)
    shapes = [(960, 960, False), (960, 320, False), (960, 2560, False),
              (2560, 960, False), (960, 49152, True)]
    rows = []
    for M in (SLOTS, prefill_m):
        for K, N, trans_b in shapes:
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


def serve_once(cfg, params, layout: str, matmul: str, reqs: list) -> dict:
    kv = (KVConfig(layout="paged", block_size=BS) if layout == "paged"
          else KVConfig(decode_block=BS))
    scfg = ServeConfig(
        max_len=MAX_LEN,
        scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=kv, kernel=KernelConfig(matmul=matmul, attention="flash"),
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
        layout=layout, matmul=matmul, tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
        itl_p50_ms=pct(itl, 0.5), itl_p95_ms=pct(itl, 0.95), ttft_p50_ms=pct(ttft, 0.5),
        launches=launches, peak_active=eng.stats["peak_active"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    print(f"serve {layout:10s} matmul={matmul:6s}: {n_tok} tokens in {wall:.3f} s "
          f"= {res['tok_per_s']:.1f} tok/s, ITL p50 {res['itl_p50_ms']:.2f} ms "
          f"p95 {res['itl_p95_ms']:.2f} ms, TTFT p50 {res['ttft_p50_ms']:.1f} ms, "
          f"launches {launches}", flush=True)
    return res, toks


def profile_decode(cfg, params, reqs, steps: int = 8) -> dict:
    """Where a decode step's time goes on the kernel path (contiguous KV,
    ``matmul="pallas"``): host wall time per step without the profiler,
    then the card's busy time per step from ``torch.profiler`` (the union
    of the CUDA kernels' intervals) and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scfg = ServeConfig(
        max_len=MAX_LEN, scheduler=SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=KVConfig(decode_block=BS), kernel=KernelConfig(matmul="pallas"),
    )
    eng = Engine(cfg, params, scfg, device=DEV)
    for r in reqs[:SLOTS]:
        eng.submit(r)
    for _ in range(3):  # admission, then warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
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
    res = dict(
        step_ms=step_ms, device_busy_ms_per_step=busy / steps / 1e3,
        busy_share=busy / steps / 1e3 / step_ms if spans else None,
        top_kernels_ms_per_step={n[:80]: t / steps / 1e3 for n, t in top},
    )
    print(f"decode step (contiguous, pallas, {SLOTS} live rows): {step_ms:.2f} ms wall, "
          f"card busy {res['device_busy_ms_per_step']:.3f} ms per step "
          f"(share of wall {res['busy_share']})", flush=True)
    for n, t in res["top_kernels_ms_per_step"].items():
        print(f"  {t:.3f} ms/step  {n}")
    return res


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
    check_gemm(results, prefill_m=SLOTS * (-(-(PREFIX + 15) // 16) * 16))

    print("== serve smollm-360m (full width, random weights)", flush=True)
    params = build(cfg).init(torch.Generator(device=DEV).manual_seed(0), DEV)
    reqs = workload(cfg)
    serve_once(cfg, params, "contiguous", "xla", reqs[:2])  # warm-up, not kept
    runs, tokens = [], {}
    totals = {n: 0 for n in WRAPPERS}
    for matmul in ("xla", "pallas"):
        for layout in ("contiguous", "paged"):
            res, toks = serve_once(cfg, params, layout, matmul, reqs)
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

    print("== reference check", flush=True)
    check_decode_step(cfg, params)

    # every reading of this run, in full, beside the built kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, device=name, torch=torch.__version__, kernels=results,
             serve=runs, decode_profile=prof, seconds=time.perf_counter() - t_start),
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
