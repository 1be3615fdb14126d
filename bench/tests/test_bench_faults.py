"""The check catches a broken program: whole runs at a CPU test's size,
each with one fault planted under the timed path, come out not correct;
and the control (the reference in float8 put in the program's place)
reads above the limit where the program reads below it."""

from __future__ import annotations

import pytest
import torch

from bench import run
from bench.harness import registry, serve, train

CPU = torch.device("cpu")


def _run(workload):
    return run.execute(workload, seed=2**31 + 5, seconds=0.5, trace=False, device=CPU)


def _token_altered(monkeypatch):
    from repro_torch.serve import engine

    real = engine.sample_rows
    calls = {"n": 0}

    def altered(logits, temperature, keys):
        out = real(logits, temperature, keys)
        calls["n"] += 1
        if calls["n"] % 3 == 0:  # the tokens of a step altered where produced
            out[:] = logits.argmin(dim=-1).cpu().numpy()
        return out

    monkeypatch.setattr(engine, "sample_rows", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.arch.transformer import Model

    real = Model.decode_step

    def frozen(self, params, tokens, caches, dispatch=None, **kw):
        lens = caches["len"].clone()
        out = real(self, params, tokens, caches, **({"dispatch": dispatch} if dispatch else {}))
        caches["len"].copy_(lens)  # the step's cache state handed back unchanged
        return out

    monkeypatch.setattr(Model, "decode_step", frozen)


def _update_skipped(monkeypatch):
    from repro_torch.train import optim

    monkeypatch.setattr(optim, "apply_updates",
                        lambda cfg, params, grads, state: (params, state, {"grad_norm": 0.0}))


def _half_batch(monkeypatch):
    from repro_torch.train import loop

    real = loop.accumulate

    def half(loss_fn, params, microbatches, constrain=None):
        return real(loss_fn, params, list(microbatches)[:1], constrain)

    monkeypatch.setattr(loop, "accumulate", half)


@pytest.mark.parametrize("workload,fault", [
    ("smollm-chat", _token_altered), ("smollm-chat", _state_unchanged),
    ("granite-moe-chat", _token_altered), ("granite-moe-chat", _state_unchanged),
    ("smollm-train", _update_skipped), ("smollm-train", _half_batch),
])
def test_a_planted_fault_makes_the_run_not_correct(tiny_bench, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["smollm-chat", "granite-moe-chat"])
def test_the_serving_control_reads_above_the_limit(tiny_bench, monkeypatch, workload):
    import bench.calibrate as calibrate

    found = {}
    monkeypatch.setattr(serve, "check", lambda *a: found.update(calibrate.serve_control(*a)) or {})
    _run(workload)
    limit = registry.cell(workload)["check"]["logit_gap"]
    print(workload, found)
    assert found["program"]["logit_gap"] <= limit < found["control"]["logit_gap"]


def test_the_training_control_and_half_batch_read_above_the_limit(tiny_bench, monkeypatch):
    import bench.calibrate as calibrate

    found = {}
    monkeypatch.setattr(train, "check", lambda *a: found.update(calibrate.train_control(*a)) or {})
    _run("smollm-train")
    limit = registry.cell("smollm-train")["check"]["grad_gap"]
    print(found)
    assert found["program"]["grad_gap"] <= limit
    assert found["control"]["grad_gap"] > limit and found["half_batch"]["grad_gap"] > limit
