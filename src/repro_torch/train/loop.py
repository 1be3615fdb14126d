"""Training loop: microbatched step, checkpoint/restart, straggler monitor;
port of ``repro/train/loop.py``.

The step (:func:`make_train_step`):

  * accumulates fp32 gradients one microbatch at a time (live activation
    memory is one microbatch's), where the reference scans its
    microbatches;
  * rematerialises each layer inside the model (``Model.loss(remat=True)``,
    ``torch.utils.checkpoint``);
  * updates parameters and optimizer state in place (``optim.apply_updates``),
    the counterpart of the reference's donated buffers.

Fault tolerance, as in the reference: ``AsyncCheckpointer`` snapshots
every ``ckpt_every`` steps and a restart resumes from the newest manifest
(the data pipeline is a pure function of the step, so the sample stream
continues exactly); the straggler monitor flags steps slower than
``straggler_factor`` x the rolling median.  ``TrainConfig.compress_grads``
is kept for the reference's field set; its loop leaves it unused too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.arch.model_zoo import build
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.train import optim


@dataclasses.dataclass
class TrainConfig:
    steps: int = 20
    microbatches: int = 1
    ckpt_every: int = 10
    ckpt_dir: str | None = None
    straggler_factor: float = 3.0
    log_every: int = 5
    compress_grads: bool = False
    opt: optim.AdamWConfig = dataclasses.field(default_factory=optim.AdamWConfig)


def value_and_grad(loss_fn: Callable, params: dict, *args) -> tuple[torch.Tensor, dict]:
    """(loss, gradients of every leaf of ``params``), gradients in each
    leaf's dtype, zeros for a leaf the loss does not reach (as JAX gives).
    ``loss_fn(params, *args)`` runs on detached views of the parameters, so
    the caller's tensors are neither marked nor given ``.grad``."""
    views = optim.tree_map(lambda p: p.detach().requires_grad_(), params)
    with obs.phase("forward"):
        loss = loss_fn(views, *args)
    with obs.phase("backward"):
        grads = torch.autograd.grad(loss, optim.tree_leaves(views), materialize_grads=True)
    return loss.detach(), optim.tree_unflatten(params, grads)


def accumulate(loss_fn: Callable, params: dict, microbatches: Iterable[tuple],
               constrain: Callable | None = None):
    """Mean loss and gradients over ``microbatches`` (argument tuples of
    ``loss_fn`` after the parameters), one backward pass at a time, the
    gradients summed in fp32 as the reference's microbatch scan sums
    them.  ``constrain`` (a tree to a tree) lays out each microbatch's
    gradients before they join the sum, and so the sum itself."""
    gsum, lsum, n = None, 0.0, 0
    for args in microbatches:
        loss, g = value_and_grad(loss_fn, params, *args)
        if constrain is not None:
            g = constrain(g)
        with obs.phase("grad_sum"):
            if gsum is None:
                gsum = optim.tree_map(lambda x: x.float(), g)
            else:
                optim.tree_map(lambda a, b: a.add_(b.float()), gsum, g)
            lsum = lsum + loss
        n += 1
    with obs.phase("grad_sum"):
        return lsum / n, optim.tree_map(lambda x: x.div_(n), gsum)


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``batch`` holds (B, T) ``tokens`` and ``labels``, split into
    ``tcfg.microbatches`` along B.  Parameters and state are updated in
    place."""

    def loss_fn(params, tokens, labels):
        return model.loss(params, tokens, labels)

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        mb = tcfg.microbatches
        if mb > 1:
            tokens = tokens.reshape((mb, -1) + tokens.shape[1:])
            labels = labels.reshape((mb, -1) + labels.shape[1:])
            loss, grads = accumulate(loss_fn, params, zip(tokens, labels))
        else:
            loss, grads = value_and_grad(loss_fn, params, tokens, labels)
        params, opt_state, metrics = optim.apply_updates(tcfg.opt, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 20
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = float(np.median(self.times[-self.window:]))
            if dt > self.factor * med:
                self.flagged.append((step, dt, med))
                slow = True
        self.times.append(dt)
        return slow


def train(
    cfg: ModelConfig,
    dcfg: DataConfig,
    tcfg: TrainConfig,
    *,
    resume: bool = True,
    pipeline: Pipeline | None = None,
    seed: int = 0,
    device=None,
) -> dict:
    """End-to-end single-device training; returns the losses, the
    final parameters, the flagged stragglers, the last step, and the host
    seconds of every step (``step_times``; a step ends in the loss's copy
    to the host) and of every ``save_async`` call (``save_times``).

    Runs on ``cuda`` unless ``device`` names another device; with no card
    visible it raises rather than running on the CPU unasked.  Parameters
    come from ``Model.init`` with a generator seeded by ``seed`` on that
    device."""
    from repro_torch.serve.engine import resolve_device

    device = resolve_device(device)
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    opt_state = optim.init_state(params)
    start_step = 0

    saver = None
    if tcfg.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
        if resume and ckpt.latest_step(tcfg.ckpt_dir) is not None:
            state, extra = ckpt.restore(tcfg.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = int(extra.get("next_step", 0))

    step_fn = make_train_step(model, tcfg)
    monitor = StragglerMonitor(factor=tcfg.straggler_factor)
    pipe = pipeline or Pipeline(dcfg, start_step=start_step)
    losses, save_times = [], []
    step = start_step
    try:
        for step, batch in pipe:
            if step >= tcfg.steps:
                break
            t0 = time.perf_counter()
            tbatch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, tbatch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            losses.append(loss)
            if step % tcfg.log_every == 0:
                print(
                    f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms"
                )
            if saver and (step + 1) % tcfg.ckpt_every == 0:
                t0 = time.perf_counter()
                saver.save_async(
                    step + 1,
                    {"params": params, "opt": opt_state},
                    extra={"next_step": step + 1},
                )
                save_times.append(time.perf_counter() - t0)
    finally:
        if pipeline is None:
            pipe.close()
        if saver:
            saver.wait()
    return {
        "losses": losses,
        "final_params": params,
        "stragglers": monitor.flagged,
        "last_step": step,
        "step_times": monitor.times,
        "save_times": save_times,
    }
