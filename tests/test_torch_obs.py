"""The training step's profiler ranges (``repro_torch.obs``) on the CPU: a
two-layer ``smollm-360m-smoke`` with every layer rematerialised, in two
microbatches, through ``loop.make_train_step``.

Without a profiler the step opens no range and its autograd graph holds
no marker; under ``torch.profiler`` it names its phases and each region
in the forward, the recompute and the backward, the ranges nest on the
timeline, and every number the step computes is the same bits."""

from __future__ import annotations

import dataclasses
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.arch.model_zoo import build
from repro_torch.configs.registry import get
from repro_torch.train import loop, optim

LAYERS, MICRO = 2, 2
REGIONS = ("embed", "norm", "attn_proj", "attention", "mlp", "head", "layer")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get("smollm-360m-smoke"), n_layers=LAYERS)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    return build(cfg), {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _fresh(model):
    params = model.init(torch.Generator().manual_seed(0))
    return params, optim.init_state(params)


def _microbatches(batch):
    t, y = batch["tokens"], batch["labels"]
    return zip(t.reshape(MICRO, -1, t.shape[1]), y.reshape(MICRO, -1, y.shape[1]))


def _step(model, batch):
    params, state = _fresh(model)
    step = loop.make_train_step(model, loop.TrainConfig(microbatches=MICRO))
    params, state, metrics = step(params, state, batch)
    return params, state, metrics


def _ranges(prof) -> list[tuple[str, int, int]]:
    return [(e.name()[len(obs.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith(obs.PREFIX)]


def _graph_nodes(root) -> list[str]:
    seen, todo, names = set(), [root], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_without_a_profiler_no_range_opens_and_the_graph_has_no_marker(setup, monkeypatch):
    model, batch = setup
    opened = []
    monkeypatch.setattr(obs, "_range", lambda name: opened.append(name))
    losses = []

    def loss_fn(params, tokens, labels):
        losses.append(model.loss(params, tokens, labels))
        return losses[-1]

    loop.accumulate(loss_fn, _fresh(model)[0], _microbatches(batch))
    _step(model, batch)
    assert opened == []
    nodes = _graph_nodes(losses[0].grad_fn)
    assert not [n for n in nodes if n.startswith(("_Enter", "_Exit"))]
    # the walk sees the markers where a profiler records
    monkeypatch.undo()
    losses.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        loop.accumulate(loss_fn, _fresh(model)[0], _microbatches(batch))
    nodes = _graph_nodes(losses[0].grad_fn)
    assert {n for n in nodes if n.startswith(("_Enter", "_Exit"))} == {
        "_EnterBackward", "_ExitBackward"}
    assert obs._STATE.phase is None and obs._STATE.open == []


def test_under_the_profiler_the_step_names_phases_and_regions_and_they_nest(setup):
    model, batch = setup
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(model, batch)
    ranges = _ranges(prof)
    n = Counter(name for name, _, _ in ranges)
    assert n["forward"] == n["backward"] == MICRO
    assert n["grad_sum"] == MICRO + 1 and n["clip"] == n["adamw"] == 1
    for r in REGIONS:
        assert n[f"{r}@forward"] >= MICRO and n[f"{r}@backward"] == n[f"{r}@forward"], r
    for r in ("layer", "attention", "mlp"):
        assert n[f"{r}@recompute"] == LAYERS * MICRO, r
    assert n["norm@recompute"] == 2 * LAYERS * MICRO
    assert n["attn_proj@recompute"] == 2 * LAYERS * MICRO
    # nest: each range ends inside the innermost one open at its start
    stack = []
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= s:
            stack.pop()
        if stack:
            assert e <= stack[-1][2], (name, stack[-1])
        else:
            assert name in ("forward", "backward", "grad_sum", "clip", "adamw"), name
        stack.append((name, s, e))
    # each recompute runs inside the backward of the layer it reruns
    for name, s, e in ranges:
        if name == "layer@recompute":
            assert any(o == "layer@backward" and os_ <= s and e <= oe for o, os_, oe in ranges)
    assert obs._STATE.phase is None and obs._STATE.open == []


def test_the_step_is_the_same_bits_with_the_profiler_on_and_off(setup):
    model, batch = setup

    def grads():
        return loop.accumulate(lambda p, t, y: model.loss(p, t, y), _fresh(model)[0],
                               _microbatches(batch))

    loss0, g0 = grads()
    p0, s0, m0 = _step(model, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        loss1, g1 = grads()
        p1, s1, m1 = _step(model, batch)
    assert torch.equal(loss0, loss1) and torch.equal(m0["loss"], m1["loss"])
    for tree0, tree1 in ((g0, g1), (p0, p1), (s0, s1)):
        for a, b in zip(optim.tree_leaves(tree0), optim.tree_leaves(tree1), strict=True):
            assert torch.equal(a, b)
