"""The split of a traced slice by the program's own ranges
(``bench/program_split.py``) on synthetic events, and the benchmark's own
summary, which reads the same from the same events with the program's
ranges in them or not."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType

from bench import program_split as ps
from bench.harness import trace
from bench.tests.test_bench_trace import _Ev

# one microbatch: host ranges of the benchmark (value_and_grad) and of the
# program, the backward's regions (as autograd's thread opens them) nested
# in the main thread's ``backward``, a recompute inside ``mlp@backward``
BENCH = [("bench.value_and_grad", 0, 400), ("bench.apply_updates", 420, 480)]
PROGRAM = [
    ("forward", 10, 100), ("layer@forward", 20, 90), ("attention@forward", 30, 50),
    ("backward", 110, 390), ("layer@backward", 120, 380), ("mlp@backward", 130, 300),
    ("layer@recompute", 140, 200), ("attention@recompute", 150, 170),
    ("attention@backward", 310, 350), ("clip", 425, 440), ("adamw", 445, 475),
]
# (name, start, end, launch): the card runs each a little after its launch
KERNELS = [
    ("k_attn_fwd", 40, 60, 35),      # attention@forward
    ("k_layer_fwd", 70, 80, 60),     # layer@forward
    ("k_fwd", 95, 105, 95),          # forward (outside the layer)
    ("k_mlp_bwd", 135, 145, 132),    # mlp@backward
    ("k_attn_re", 160, 175, 155),    # attention@recompute
    ("k_layer_re", 180, 190, 175),   # layer@recompute
    ("k_mlp_bwd2", 210, 240, 205),   # mlp@backward
    ("k_attn_bwd", 320, 340, 315),   # attention@backward
    ("k_bwd", 385, 395, 375),        # layer@backward
    ("k_clip", 430, 435, 428),       # clip
    ("k_adamw", 450, 470, 446),      # adamw
    ("k_loss", 490, 495, 485),       # under no program range
    ("k_lost", 496, 498, None),      # launch unknown
]


def test_self_time_under_nesting_is_a_partition():
    got = ps.split(KERNELS, BENCH, ps.program_ranges(_events(PROGRAM)), steps=1)
    assert got["program_ms"] == pytest.approx({
        "attention@forward": 20e-6, "layer@forward": 10e-6, "forward": 10e-6,
        "mlp@backward": 40e-6, "attention@recompute": 15e-6, "layer@recompute": 10e-6,
        "attention@backward": 20e-6, "layer@backward": 10e-6, "clip": 5e-6,
        "adamw": 20e-6})
    # the kernels launched under no range, or at no known time, count for none
    assert got["under_program"] == pytest.approx(160 / 167)
    assert got["groups"] == pytest.approx({
        "fwd": 40e-6, "bwd": 70e-6, "remat": 25e-6, "attn": 55e-6, "head": 0.0,
        "optim": 25e-6})
    assert list(got["program_ms"])[0] == "mlp@backward"  # largest first


def test_per_step_and_a_kernel_launched_on_another_thread():
    # autograd's thread launches while the thread that opened ``backward``
    # waits: the kernel counts for the range open, in time, at its launch
    kernels = [("k", 160, 200, 165)]
    got = ps.split(kernels, [], [("backward", 100, 300), ("attention@recompute", 150, 170)],
                   steps=2)
    assert got["program_ms"] == pytest.approx({"attention@recompute": 20e-6})


def test_idle_gaps_take_the_innermost_range_of_either_kind():
    got = dict(ps.split(KERNELS, BENCH, PROGRAM, steps=1)["idle_gaps"])
    # the card idles in [0,40) [60,70) [80,95) [105,135) [145,160) [175,180)
    # [190,210) [240,320) [340,385) [395,430) [435,450) [470,490) [495,496)
    assert got == pytest.approx({k: v * 1e-9 for k, v in {
        "value_and_grad": 10 + 5 + 5, "forward": 10 + 5, "layer@forward": 10 + 10 + 10,
        "attention@forward": 10, "backward": 10 + 5, "layer@backward": 10 + 10 + 30,
        "mlp@backward": 5 + 10 + 60, "layer@recompute": 5 + 5 + 10,
        "attention@recompute": 10, "attention@backward": 10 + 10, "harness": 20 + 10 + 1,
        "apply_updates": 5 + 5 + 5, "clip": 5 + 5, "adamw": 5 + 5}.items()})


def _events(program, mirrored=()):
    """Kineto-like events: each kernel's launch call and kernel (one
    correlation id), the benchmark's ranges and their device mirrors, and
    the program's ranges, host events of the kind torch's operations are."""
    evs = []
    for i, (name, s, e, launch) in enumerate(KERNELS):
        if launch is not None:
            evs.append(_Ev("cudaLaunchKernel", DeviceType.CPU, launch, 2, 1000 + i,
                           kind="cuda_runtime"))
        evs.append(_Ev(name, DeviceType.CUDA, s, e - s, 1000 + i if launch else 5000 + i,
                       kind="kernel"))
    for j, (name, s, e) in enumerate(BENCH):
        evs.append(_Ev(name, DeviceType.CPU, s, e - s, 7000 + j, kind="user_annotation"))
        evs.append(_Ev(name, DeviceType.CUDA, s + 5, e - s - 10, 7000 + j,
                       kind="gpu_user_annotation"))
    for j, (name, s, e) in enumerate(program):
        evs.append(_Ev("repro_torch." + name, DeviceType.CPU, s, e - s, 8000 + j))
    for j, (name, s, e) in enumerate(mirrored):
        evs.append(_Ev("repro_torch." + name, DeviceType.CUDA, s, e - s, 8000 + j,
                       kind="gpu_user_annotation"))
    return evs


def test_the_benchmarks_summary_reads_the_same_with_the_programs_ranges():
    without = trace.summarize_kineto(_events(()))
    with_ = trace.summarize_kineto(_events(PROGRAM))
    assert with_ == without
    assert without["launch_known"] == pytest.approx(12 / 13)
    # a range mirrored on the card would count as a kernel: the program's
    # ranges are of a kind the profiler does not mirror (``mirrored`` reads 0
    # on the card)
    assert trace.summarize_kineto(_events(PROGRAM, [("forward", 12, 98)])) != without


def test_capture_keeps_the_lists_and_leaves_the_summary(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.arch.model_zoo import build
    from repro_torch.configs.registry import get
    from repro_torch.train import loop, optim

    for attr in ("summarize_kineto", "summarize_events"):
        monkeypatch.setattr(trace, attr, getattr(trace, attr))
    cfg = dataclasses.replace(get("smollm-360m-smoke"), n_layers=1)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    step = loop.make_train_step(model, loop.TrainConfig(microbatches=2))
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.value_and_grad"):
            step(params, optim.init_state(params), {"tokens": tokens, "labels": tokens})
    plain = trace.summarize(prof)
    seen = ps.capture()
    assert trace.summarize(prof) == plain
    names = {n for n, _, _ in seen["program"]}
    assert {"forward", "backward", "grad_sum", "clip", "adamw", "layer@recompute",
            "attention@backward", "head@forward"} <= names
    assert seen["kernels"] == [] and [r[0] for r in seen["ranges"]] == ["bench.value_and_grad"]
    assert seen["mirrored"] == 0
