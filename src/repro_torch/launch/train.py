"""Training launcher; port of ``repro/launch/train.py``.

Runs the step of ``launch/steps.py`` on the host mesh (``launch/mesh.py``):
the launch's ranks as a (data, model) mesh, one rank unless the program
runs under ``torchrun``.  As in the reference, a ``ShardingPlan`` places
the parameters (FSDP) and the optimizer state, the activation policy is
active, each data rank takes its slice of every batch, and the step,
data pipeline, asynchronous checkpoints and straggler monitor are the
dry-run's.  ``--device cuda`` (the default; it fails when no card is
visible) runs NCCL, ``--device cpu`` gloo.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m-smoke --steps 20 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.arch.model_zoo import build
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import get
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.parallel import policy
from repro_torch.parallel.sharding import P, ShardingPlan
from repro_torch.serve.engine import resolve_device
from repro_torch.train import optim
from repro_torch.train.loop import StragglerMonitor


def main(argv=None) -> list[float]:
    """Trains as the flags say; returns every step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if cfg.family in ("encdec", "vlm"):
        ap.error(f"{args.arch}: the launcher feeds token batches only; the {cfg.family} "
                 f"family also needs {'frames' if cfg.family == 'encdec' else 'patches'}")
    if args.batch % args.microbatches:
        ap.error(f"--batch {args.batch} is not a multiple of --microbatches {args.microbatches}")
    device = resolve_device(args.device)
    mesh = make_host_mesh(device.type)
    plan = ShardingPlan(mesh)
    params = build(cfg).init(torch.Generator(device=device).manual_seed(0), device)
    opt_state = optim.init_state(params)
    pspec = plan.param_spec(params)
    params = plan.place(params, pspec)
    opt_state = plan.place(opt_state, plan.opt_state_spec(pspec))
    step_fn = make_train_step(
        cfg, optim.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    pipe = Pipeline(dcfg)
    monitor = StragglerMonitor()
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    mb = args.microbatches
    losses = []
    # batch leaves are (mb, bm, ...): dim 1 over the data ranks
    bspec = P(None, plan.dp_axes, None)
    try:
        with policy.activate(mesh):
            for step, batch in pipe:
                if step >= args.steps:
                    break
                t0 = time.perf_counter()
                shaped = {
                    k: torch.from_numpy(v).to(device).reshape((mb, -1) + v.shape[1:])
                    for k, v in batch.items()
                }
                shaped = plan.place(shaped, {k: bspec for k in shaped})
                params, opt_state, metrics = step_fn(params, opt_state, shaped)
                loss = float(metrics["loss"].full_tensor())
                losses.append(loss)
                dt = time.perf_counter() - t0
                monitor.record(step, dt)
                if step % 5 == 0:
                    print(f"step {step} loss {loss:.4f} {dt*1e3:.0f}ms", flush=True)
                if saver and (step + 1) % args.ckpt_every == 0:
                    saver.save_async(step + 1, {"params": params, "opt": opt_state},
                                     extra={"next_step": step + 1})
    finally:
        pipe.close()
        if saver:
            saver.wait()
    print(f"done; stragglers: {len(monitor.flagged)}")
    return losses


if __name__ == "__main__":
    main()
