"""Step functions shared by the dry-run, train and serve launchers; port
of ``repro/launch/steps.py``.

The reference builds pure functions to jit with explicit shardings for the
production mesh.  Here a step runs eagerly and updates parameters and
optimizer state in place; on a mesh its leaves are DTensors placed by the
sharding plan (``parallel/sharding.py``), and the same code runs on each
rank's shards.
"""

from __future__ import annotations

from typing import Any, Callable

from torch.distributed.tensor import DTensor

from repro_torch.arch.model_zoo import build
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import map_with_path, placements
from repro_torch.train import optim
from repro_torch.train.loop import accumulate


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """loss(params, batch) for the config's family: ``frames`` for the
    encoder-decoder, ``patches`` for the VLM, then ``tokens`` and
    ``labels``."""
    model = build(cfg)
    if cfg.family == "encdec":
        return lambda p, b: model.loss(p, b["frames"], b["tokens"], b["labels"])
    if cfg.family == "vlm":
        return lambda p, b: model.loss(p, b["tokens"], b["labels"], patches=b["patches"])
    return lambda p, b: model.loss(p, b["tokens"], b["labels"])


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig,
                    accum_spec: Any | None = None) -> Callable:
    """Microbatched train step(params, opt_state, batch) -> (params,
    opt_state, metrics).  Batch leaves are pre-shaped (microbatches,
    per_mb_batch, ...); the gradients accumulate in fp32 one microbatch at
    a time, so live activation memory is one microbatch's.

    accum_spec (§Perf, grok hillclimb): a spec tree pinning each
    microbatch's gradients, and so the fp32 accumulator, to the PARAM
    sharding.  Without it a DTensor gradient keeps the placement its
    backward gave it (``Partial`` over the data axes), and the sum is
    reduced as a whole; with it each microbatch's reduction is a
    reduce-scatter of the already-sharded gradients."""
    loss_fn = make_loss_fn(cfg)

    def constrain(tree):
        def one(path, g):
            spec = accum_spec
            for k in path:
                spec = spec[k]
            if not isinstance(g, DTensor):
                return g
            return g.redistribute(g.device_mesh, placements(g.device_mesh, spec))

        return map_with_path(one, tree)

    def step(params, opt_state, batch):
        mb = next(iter(batch.values())).shape[0]
        per_mb = ([{k: v[i] for k, v in batch.items()}] for i in range(mb))
        loss, grads = accumulate(loss_fn, params, per_mb,
                                 constrain if accum_spec is not None else None)
        params, opt_state, metrics = optim.apply_updates(ocfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    model = build(cfg)
    if cfg.family == "encdec":
        def step(params, batch, caches):
            logits, (caches, enc_out) = model.prefill(
                params, batch["frames"], batch["tokens"], caches
            )
            return logits, caches, enc_out
        return step
    if cfg.family == "vlm":
        def step(params, batch, caches):
            return model.prefill(params, batch["tokens"], caches, patches=batch["patches"])
        return step

    def step(params, batch, caches):
        return model.prefill(params, batch["tokens"], caches)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    model = build(cfg)
    if cfg.family == "encdec":
        def step(params, tokens, caches, enc_out):
            logits, (caches, enc_out) = model.decode_step(params, tokens, (caches, enc_out))
            return logits, caches
        return step

    def step(params, tokens, caches):
        return model.decode_step(params, tokens, caches)

    return step
