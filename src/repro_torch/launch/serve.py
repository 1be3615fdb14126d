"""Serving launcher on the port's continuous-batching engine; port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --max-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --autotune \
        --concurrency 16 --max-len 1024 --matmul pallas

``--arch`` takes every name of ``configs/registry.py`` (and its
``-smoke`` variant).  The engine serves decoder-only models, so
whisper-medium is refused with a usage error; llava-next-34b serves as a
text LM (no image patches), as in the reference.

Generates a mixed-length synthetic workload with random weights, streams
tokens through the engine, and reports throughput plus per-token latency.
``--static`` runs the padded static-batch baseline instead (same workload,
same slot count) for an A/B on the spot.  ``--snapshot-dir D`` makes the
run crash-consistent (snapshots plus a write-ahead journal under D); after a
crash, the same command with ``--resume`` restores the engine from D,
prints the recovery report and finishes the requests in flight (the
weights come from the same seeded generator, so they are the same).
``--autotune`` plans the serving knobs (slots, KV layout, block size, pool
size, prefill chunk, token budget) with the serve planner
(``core/serveplan.py``, priced for the H100), prints an ``[autotune]`` line
and serves the plan; with ``--abft`` it plans the paged layout only, which
the SDC defense needs.  Plans persist in ``REPRO_TORCH_SERVE_PLAN_CACHE``
(default ``build/repro_torch/serve_plans.json``).  Runs on the card
(``--device cuda``, the default; it fails when no card is visible) or,
asked explicitly, on the CPU with the plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs.registry import ARCHS, get
from repro_torch.core.serveplan import ServePlanSpace, ServeWorkload
from repro_torch.serve import recovery
from repro_torch.serve.engine import (
    DurabilityConfig,
    Engine,
    KernelConfig,
    KVConfig,
    Request,
    SchedulerConfig,
    ServeConfig,
    StaticEngine,
    resolve_device,
)


def make_workload(
    cfg, n: int, max_new: int, seed: int = 0, deadline: int | None = None
) -> list[Request]:
    """The reference's ``make_workload``, draw for draw (same numpy
    generator calls), so both engines serve identical requests."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rng.integers(0, cfg.vocab, rng.integers(3, 16)).astype(np.int32),
            max_new=int(rng.integers(max(2, max_new // 4), max_new + 1)),
            request_id=i,
            deadline_steps=deadline,
        )
        for i in range(n)
    ]


def latency_summary(stamps: dict[int, list[float]]) -> tuple[float, float]:
    """p50/p95 of the gaps between consecutive token stamps of each
    request (the first gap is measured from the start of the run)."""
    deltas = sorted(
        b - a for ts in stamps.values() for a, b in zip([0.0] + ts[:-1], ts)
    )
    if not deltas:
        return 0.0, 0.0
    return deltas[len(deltas) // 2], deltas[min(len(deltas) - 1, int(len(deltas) * 0.95))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke",
                    choices=sorted(ARCHS) + sorted(f"{a}-smoke" for a in ARCHS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-bucket", type=int, default=16)
    ap.add_argument("--matmul", choices=("xla", "pallas"), default="xla",
                    help="'pallas' routes projections through the "
                         "hand-written GEMM kernel")
    ap.add_argument("--attention", choices=("flash", "xla"), default="flash",
                    help="decode attention: the ragged decode kernel or "
                         "the masked dense oracle")
    ap.add_argument("--abft", choices=("off", "checksum", "paranoid"), default="off",
                    help="silent-data-corruption defense: 'checksum' "
                         "column-checksums every decode GEMM, fingerprints "
                         "4 sampled rows of each decode attention and "
                         "scrubs the weights; a flagged step is retried, a "
                         "corrupt KV block quarantines its request; "
                         "'paranoid' fingerprints every row (needs "
                         "--kv-layout paged)")
    ap.add_argument("--scrub-every", type=int, default=1,
                    help="abft: decode steps between weight-fingerprint "
                         "scrubs (1 = every step)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default="contiguous")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per physical KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged: pool blocks per layer incl. the sink")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--max-waiting", type=int, default=None)
    ap.add_argument("--stall-patience", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="unified scheduler: split admission prefills into "
                         "fixed chunks of this many tokens and interleave "
                         "them with decode steps (0 = monolithic admission, "
                         "the bitwise oracle; max-len must be a multiple)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max prefill tokens advanced per engine step "
                         "(requires --prefill-chunk; default unlimited). "
                         "Lower budgets flatten decode ITL under admission "
                         "storms at the cost of TTFT")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request deadline in engine steps; expired "
                         "requests end FAILED with their partial output")
    ap.add_argument("--snapshot-dir", default=None,
                    help="arm crash consistency: atomic engine snapshots "
                         "plus a write-ahead journal under this directory "
                         "(created if missing); relaunch with --resume to "
                         "recover after a crash")
    ap.add_argument("--snapshot-every", type=int, default=32,
                    help="steps between snapshots (journal records land "
                         "every step regardless)")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --snapshot-dir instead of submitting "
                         "a fresh workload: replay the journal, print the "
                         "recovery report, and finish the in-flight requests")
    ap.add_argument("--static", action="store_true",
                    help="run the padded static-batch baseline instead")
    ap.add_argument("--autotune", action="store_true",
                    help="plan the serving knobs with the DSE planner "
                         "(core/serveplan.py, priced for the H100): sweep "
                         "slots / kv layout / block_size / num_blocks / "
                         "prefill_chunk / token_budget under an iso-HBM KV "
                         "budget, take the Pareto winner, and serve with it.  "
                         "Overrides --slots/--kv-layout/--block-size/"
                         "--num-blocks/--prefill-chunk/--token-budget; kernel "
                         "and durability flags still apply.  Winning plans "
                         "persist in REPRO_TORCH_SERVE_PLAN_CACHE")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="autotune: offered concurrency to plan for "
                         "(default: --requests)")
    args = ap.parse_args(argv)
    if args.resume and not args.snapshot_dir:
        ap.error("--resume requires --snapshot-dir")
    if args.autotune and args.static:
        ap.error("--autotune plans the continuous engine (drop --static)")
    if args.static and (args.snapshot_dir or args.resume):
        ap.error("--snapshot-dir/--resume need the continuous engine "
                 "(drop --static)")
    if args.abft != "off" and args.kv_layout != "paged" and not args.autotune:
        ap.error("--abft localizes corruption through the paged pool's "
                 "per-block fingerprints (add --kv-layout paged)")
    if args.static and args.kv_layout != "contiguous":
        ap.error("--static serves the contiguous layout only (drop --kv-layout)")
    if args.static and args.abft != "off":
        ap.error("--abft needs the continuous engine's paged layout (drop --static)")
    if args.token_budget is not None and not args.prefill_chunk:
        ap.error("--token-budget requires --prefill-chunk")

    cfg = get(args.arch)
    if cfg.family == "encdec":
        ap.error("continuous batching serves decoder-only LMs; whisper-style "
                 "encdec requests need per-request encoder state")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = build(cfg).init(gen, device)
    kernel = KernelConfig(
        matmul=args.matmul, attention=args.attention,
        abft=args.abft, scrub_every=args.scrub_every,
    )
    durability = DurabilityConfig(
        snapshot_dir=args.snapshot_dir, snapshot_every=args.snapshot_every,
    )
    if args.autotune:
        scfg = ServeConfig.autotune(
            cfg,
            max_len=args.max_len,
            workload=ServeWorkload(
                concurrency=args.concurrency or args.requests,
                prompt_len=16,
                decode_len=max(2, args.new_tokens),
            ),
            # the SDC defense needs the paged pool
            space=ServePlanSpace(layouts=("paged",)) if args.abft != "off" else None,
            temperature=args.temperature,
            seed=args.seed,
            kernel=kernel,
            durability=durability,
        )
        plan = scfg.autotune_plan
        k, pred = plan.knobs, plan.predicted
        print(
            f"[autotune] {plan.source}: slots={k.slots} "
            f"kv={k.kv_layout}/bs={k.block_size}/nb={k.num_blocks} "
            f"chunk={k.prefill_chunk} budget={k.token_budget} "
            f"(predicted {pred.get('tokens_per_s', 0):.0f} tok/s over "
            f"{pred.get('swept_points', '?')} swept points, "
            f"frontier {plan.frontier_size})"
        )
    else:
        scfg = ServeConfig(
            max_len=args.max_len, temperature=args.temperature, seed=args.seed,
            scheduler=SchedulerConfig(
                batch=args.slots, prefill_bucket=args.prefill_bucket,
                prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                max_waiting=args.max_waiting, stall_patience=args.stall_patience,
            ),
            kv=KVConfig(
                layout=args.kv_layout, block_size=args.block_size,
                num_blocks=args.num_blocks,
                prefix_sharing=not args.no_prefix_sharing,
            ),
            kernel=kernel,
            durability=durability,
        )
    mode = "static" if args.static else "resume" if args.resume else "continuous"
    if args.resume:
        eng, report = recovery.restore_engine(cfg, params, scfg, device=device)
        print(
            f"[resume] source={report.source} snapshot={report.snapshot_key} "
            f"segments={report.segments} records={report.records} "
            f"torn={report.torn_lines}"
        )
        print(
            f"[resume] resubmitted={report.resubmitted} "
            f"tokens_replayed={report.tokens_replayed} "
            f"cancels={report.cancels} pops={report.pops} "
            f"quarantined={report.quarantined or '[]'}"
        )
        rids = sorted(eng._reqs)
    else:
        reqs = make_workload(
            cfg, args.requests, args.new_tokens, args.seed, deadline=args.deadline_steps
        )
        rids = [r.request_id for r in reqs]
        if args.static:
            eng = StaticEngine(cfg, params, scfg, device=device)
        else:
            eng = Engine(cfg, params, scfg, device=device)

    stamps: dict[int, list[float]] = {}
    t0 = time.perf_counter()

    def on_token(rid, tok, idx, done):
        stamps.setdefault(rid, []).append(time.perf_counter() - t0)

    if args.static:
        outs = eng.generate(reqs, on_token=on_token)
    else:
        with eng:
            if not args.resume:
                for r in reqs:
                    eng.submit(r)
            while eng.step(on_token):
                pass
            outs = [eng.pop_result(r) for r in rids]
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    p50, p95 = latency_summary(stamps)
    print(
        f"[{mode}/{device.type}] served {len(rids)} requests, {total_new} "
        f"tokens, {dt:.2f}s ({total_new / dt:.1f} tok/s, per-token "
        f"p50={p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms)"
    )
    if args.static:
        for i, o in enumerate(outs):
            print(f"  req{i}: {o.tolist()}")
        return
    if args.abft != "off":
        st = eng.stats
        print(f"  abft={args.abft}: sdc_detected={st['sdc_detected']} "
              f"sdc_retried={st['sdc_retried']} quarantined={st['quarantined']}")
    counts: dict[str, int] = {}
    for o in outs:
        counts[o.status.value] = counts.get(o.status.value, 0) + 1
    print("  statuses: " + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    for i, o in enumerate(outs):
        why = f" ({o.reason})" if o.reason else ""
        print(f"  req{i} [{o.status.value}{why}]: {o.tolist()}")


if __name__ == "__main__":
    main()
