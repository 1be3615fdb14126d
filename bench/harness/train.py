"""A training cell: the program's ``make_train_step`` over ``Model.loss``.

Set-up draws the weights from the seed (the parameters the program then
trains in place), builds the optimizer state and the step, makes the
mix's batches (every row distinct), and drives the step through its first
``check_steps`` steps, which also build and warm everything the window
runs.  From those steps it keeps what the check compares: each step's
loss, each leaf's norm of the first gradient as the optimizer got it
(worked out from the first moment after one step, ``m = (1 - b1) g``), and
each leaf's norm of its change over the steps.  The window then runs
steps until ``seconds`` have passed, to the end of the step in which they
pass; a step ends when its loss has been copied to the host.  With
``trace`` a profiled slice of ``trace_steps`` more steps follows.

Once the window has closed the program's state is freed, the weights are
drawn again from the seed, and the float32 reference takes the same
steps on the same batches.
"""

from __future__ import annotations

import gc
import statistics
import time
from types import SimpleNamespace

from bench.harness import model as bmodel
from bench.harness import registry
from bench.harness import trace as btrace
from bench.harness.spans import Tracker


def train_flops(d: dict, rows: int, T: int) -> float:
    """Model operations of one step of ``rows`` sequences of ``T`` tokens:
    six per parameter and token (forward and backward; the tied
    unembedding counted, the embedding lookup not), plus causal attention,
    three times its forward's T(T+1)/2 query-key pairs."""
    p = bmodel.param_counts(d)
    params = d["layers"] * p["layer_active"] + p["unembed"]
    attn = 3 * 4.0 * d["layers"] * d["heads"] * d["head_dim"] * T * (T + 1) / 2
    return rows * (6.0 * params * T + attn)


def _norms(tree: dict, scale: float = 1.0) -> dict[str, float]:
    import torch

    from bench.reference.lm import leaves

    return {k: float(torch.linalg.vector_norm(v.float())) * scale for k, v in leaves(tree).items()}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    import torch

    from repro_torch.arch.model_zoo import build
    from repro_torch.train import loop, optim
    from bench.reference.lm import leaves

    d = bmodel.dims(cell["model"])
    ts, mix = cell["train"], cell["mix"]
    rows, T = mix["rows"], mix["seq_len"]
    tokens_per_step = rows * T
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in registry.generator(mix["kind"]).batches(mix, d["vocab"], seed,
                                                                mix["batches"])]
    tracker = Tracker(ctx={"dims": d}).install()
    try:
        params = bmodel.make_weights(cell["model"], seed, device)
        start = {k: v.detach().clone() for k, v in leaves(params).items()}
        opt_state = optim.init_state(params)
        opt = optim.AdamWConfig(**ts["opt"])
        step_fn = loop.make_train_step(
            build(bmodel.port_config(cell["model"])),
            loop.TrainConfig(microbatches=mix["microbatches"], opt=opt))
        step_no = 0

        def step() -> float:
            nonlocal params, opt_state, step_no
            batch = batches[step_no % len(batches)]
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            step_no += 1
            return float(metrics["loss"])

        losses, first_grad = [], None
        for _ in range(ts["check_steps"]):
            losses.append(step())
            if first_grad is None:
                first_grad = _norms(opt_state["m"], 1.0 / (1.0 - opt.b1))
        change = {k: float(torch.linalg.vector_norm(v.float() - start[k].float()))
                  for k, v in leaves(params).items()}
        del start
        btrace.sync(device)
        setup_s = time.perf_counter() - t_start
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's way in the window

        tracker.reset()
        t0 = time.perf_counter()
        steps, window_losses = 0, []
        while True:
            window_losses.append(step())
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        gc.unfreeze()
        host = SimpleNamespace(host_s=dict(tracker.host_s), calls=dict(tracker.calls))

        summary, slice_ = None, None
        if trace:
            summary, slice_ = profiled_slice(step, tracker, ts["trace_steps"], device,
                                             train_flops(d, rows, T))
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        tracker.restore()
    del params, opt_state, step_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    prog = {"losses": losses, "first_grad": first_grad, "change": change}
    checks = check(cell, d, seed, device, batches, prog)
    bad = sum(1 for x in window_losses if not x == x or abs(x) == float("inf"))
    return {
        "e2e": {"setup_s": setup_s, "train_tok_s": steps * tokens_per_step / (t1 - t0)},
        "attempted": steps, "failed": bad, "checks": checks,
        "memory_peak_bytes": int(peak), "trace": summary,
        "view": SimpleNamespace(kind="train", window_s=t1 - t0, steps=steps, **vars(host),
                                slice=slice_),
    }


def profiled_slice(step, tracker: Tracker, steps: int, device, flops_per_step: float):
    """``steps`` training steps under the profiler: (trace summary, the
    slice's counts for the readers)."""
    summary = btrace.profile_steps(step, steps, tracker, device)
    return summary, SimpleNamespace(
        window_s=summary["window_s"], steps=steps, calls=dict(tracker.calls),
        flops={"train_step": flops_per_step * steps}, bytes={}, bound_s={},
        host_s=dict(tracker.host_s), device_ms=summary["device_ms"], busy_s=summary["busy_s"])


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers the check compares.  ``loss_gap``: the largest
    difference of a step's loss.  ``grad_gap`` and ``change_gap``: by the
    worst leaf, the difference of the program's and the reference's norms
    over the larger of the reference's norm of that leaf and the median
    leaf's; leaves whose reference gradient is under a thousandth of the
    median leaf's (moved by round-off alone) are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["first_grad"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["first_grad"][k] - g) / max(g, g_med) for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change_gap = max(abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def reference(cell: dict, d: dict, seed: int, device, batches, precision: str = "fp32") -> dict:
    from bench.reference import lm

    lm.no_tf32()
    weights = bmodel.make_weights(cell["model"], seed, device)
    return lm.train(weights, d, batches, cell["train"]["opt"], cell["train"]["check_steps"],
                    precision)


def check(cell: dict, d: dict, seed: int, device, batches, prog: dict) -> dict:
    """The numbers of :func:`compare` that the cell's ``check`` gives a
    limit (a number with no reading that a lower precision or a fault
    exceeds is not compared)."""
    got = compare(prog, reference(cell, d, seed, device, batches))
    return {k: {"value": got[k], "limit": lim} for k, lim in cell["check"].items()}
