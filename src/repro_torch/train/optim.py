"""Hand-rolled AdamW and its schedule; port of ``repro/train/optim.py``.

Parameters are the port's nested dict of tensors.  The state mirrors them
(``m`` and ``v`` per leaf, fp32) beside an int32 scalar ``step``, as in the
reference.  :func:`apply_updates` updates parameters and state **in
place** under ``torch.no_grad()``, where the reference donates them to a
jitted step, and returns the same objects.  Per leaf the arithmetic is the
reference's: the gradient, moments and update in fp32, the new parameter
cast back to its dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


# ------------------------------------------------------------------ trees --


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a nested dict in JAX's order (keys sorted at every
    level); an empty dict has none."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ------------------------------------------------------------------- AdamW --


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.clamp(warm, max=1.0) * decay


def init_state(params: dict) -> dict:
    """Zero fp32 moments per leaf and step 0, on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig, params: dict, grads: dict, state: dict
) -> tuple[dict, dict, dict]:
    """One AdamW step, in place; returns (params, state, metrics), the
    objects it was given."""
    with obs.phase("clip"):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    with obs.phase("adamw"):
        step = state["step"] + 1
        lr = lr_schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        sf = step.float()
        c1, c2 = 1 - b1**sf, 1 - b2**sf

        def upd(p, g, m, v):
            gf = g.float()
            m2 = b1 * m + (1 - b1) * gf
            v2 = b2 * v + (1 - b2) * gf * gf
            delta = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m2)
            v.copy_(v2)

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            upd(p, g, m, v)
        state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
