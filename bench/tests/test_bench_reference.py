"""The float32 reference against the program's plain path at a CPU test's
size, both in float32 on the same weights: prefill and decode through the
cache (a mixture of experts with capacity drops included), and training
steps; and the weights' layout against the program's own."""

from __future__ import annotations

import pytest
import torch

from bench.harness import model as bmodel
from bench.reference import lm
from conftest import tiny_config


def _f32(name: str, **over) -> dict:
    return {**tiny_config(name), "torch_dtype": "float32", **over}


def test_layout_is_the_programs():
    from repro_torch.arch.model_zoo import build

    for name in ("smollm-360m", "granite-moe-1b-a400m"):
        model = tiny_config(name)
        mine = lm.leaves(bmodel.make_weights(model, 3, torch.device("cpu")))
        cfg = bmodel.port_config(model)
        theirs = lm.leaves(build(cfg).init(torch.Generator().manual_seed(0)))
        assert {k: (v.shape, v.dtype) for k, v in mine.items()} == {
            k: (v.shape, v.dtype) for k, v in theirs.items()}


@pytest.mark.parametrize("name,over", [
    ("smollm-360m", {}),
    ("granite-moe-1b-a400m", {}),
    # capacity tight enough that the prompt's experts overflow
    ("granite-moe-1b-a400m", {"capacity_factor": 0.5}),
])
def test_prefill_and_decode_match_the_reference(name, over):
    from repro_torch.arch.model_zoo import build
    from repro_torch.serve import kvcache

    model = _f32(name, **over)
    dims = bmodel.dims(model)
    cfg = bmodel.port_config(model)
    w = bmodel.make_weights(model, 11, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, dims["vocab"], (24,), generator=g)
    served = torch.randint(0, dims["vocab"], (8,), generator=g)
    m = build(cfg)
    caches = kvcache.build_caches(cfg, 1, 64)
    with torch.no_grad():
        first, caches = m.prefill(w, prompt[None], caches)
        rows = [first[0]]
        for t in served[:-1]:
            logits, caches = m.decode_step(w, t.view(1, 1), caches)
            rows.append(logits[0])
        want = lm.served_rows(w, dims, prompt, served)
    got = torch.stack(rows).float()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_training_steps_match_the_reference():
    from repro_torch.arch.model_zoo import build
    from repro_torch.train import loop, optim

    from bench.harness import registry, train

    model = _f32("smollm-360m")
    dims = bmodel.dims(model)
    mix = {"kind": "pretrain", "seq_len": 16, "rows": 4, "microbatches": 2, "structure": 0.8}
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in registry.generator("pretrain").batches(mix, dims["vocab"], 5, 2)]
    opt = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
           "warmup_steps": 10, "total_steps": 100, "min_lr_ratio": 0.1}
    params = bmodel.make_weights(model, 2, torch.device("cpu"))
    start = {k: v.clone() for k, v in lm.leaves(params).items()}
    state = optim.init_state(params)
    step = loop.make_train_step(build(bmodel.port_config(model)),
                                loop.TrainConfig(microbatches=2, opt=optim.AdamWConfig(**opt)))
    losses, first = [], None
    for b in batches:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        if first is None:
            first = {k: float(v.norm()) / (1 - opt["b1"]) for k, v in lm.leaves(state["m"]).items()}
    change = {k: float((v - start[k]).norm()) for k, v in lm.leaves(params).items()}
    ref = lm.train(bmodel.make_weights(model, 2, torch.device("cpu")), dims, batches, opt, 2)
    got = train.compare({"losses": losses, "first_grad": first, "change": change}, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3
