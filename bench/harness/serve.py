"""A serving cell: the program's ``Engine`` under the cell's traffic.

Set-up draws the weights from the seed, builds the engine from the cell
file's ``serve`` settings (:func:`serve_config`), installs the spans, and
runs ``warmup_steps`` engine steps of the cell's own traffic (which also
builds every kernel the window uses).  The traffic comes from the
generator its mix names (``bench/generators/<kind>.py``): after every
engine step the driver sends what the generator says is due.  The window
then runs engine steps until ``seconds`` have passed, to the end of the
step in which they pass.  With ``trace`` a profiled slice of
``trace_steps`` more steps follows the window.

Once the window has closed the engine is freed, and a sample of the
requests the window finished, drawn from the seed and always holding the
longest, goes to the float32 reference: the widest gap by which a served
token's logit lies below the reference's best at its position is the
number compared (``checks``).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import SimpleNamespace

import numpy as np

from bench.harness import model as bmodel
from bench.harness import trace as btrace
from bench.harness import registry
from bench.harness.spans import Tracker


@dataclasses.dataclass
class Req:
    prompt: np.ndarray
    budget: int
    submitted: float
    stamps: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile of every value in ``xs`` (linear between
    ranks)."""
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def window_latency(reqs: dict[int, Req], t0: float, t1: float) -> dict:
    """The window's end-to-end serving numbers (seconds in, ms out).
    ``out_tok_s``: tokens handed to clients in [t0, t1] over its length.
    ``ttft_p95_ms``: over every request submitted in the window, submission
    to first token, or to t1 for one still waiting.  ``itl_p95_ms``: every
    gap between consecutive tokens of a request, both inside the window."""
    tokens, ttft, itl = 0, [], []
    for r in reqs.values():
        inside = [s for s in r.stamps if t0 <= s <= t1]
        tokens += len(inside)
        itl += list(np.diff(inside))
        if t0 <= r.submitted <= t1:
            first = r.stamps[0] if r.stamps and r.stamps[0] <= t1 else t1
            ttft.append(first - r.submitted)
    return {"out_tok_s": tokens / (t1 - t0),
            "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else None,
            "itl_p95_ms": percentile(itl, 95) * 1e3 if itl else None,
            "tokens": tokens, "ttft_n": len(ttft), "itl_n": len(itl)}


def serve_config(spec: dict):
    """The program's ``ServeConfig`` from a cell's ``serve`` settings: each
    of ``scheduler``, ``kv``, ``kernel`` and ``durability`` goes whole into
    its sub-config, every other key (``max_len``, ...) to ``ServeConfig``
    itself, so any field the program has can be set from a cell file."""
    from repro_torch.serve import engine

    subs = {"scheduler": engine.SchedulerConfig, "kv": engine.KVConfig,
            "kernel": engine.KernelConfig, "durability": engine.DurabilityConfig}
    top = {k: v for k, v in spec.items() if k not in subs}
    if top.get("temperature", 0.0) != 0.0:
        # the check compares served tokens with the reference's best
        raise ValueError("the serving check is for greedy decoding only (temperature 0)")
    return engine.ServeConfig(**top, **{k: cls(**spec[k]) for k, cls in subs.items()
                                        if k in spec})


class Driver:
    """Submits the traffic's requests to ``eng`` and keeps, from the token
    callbacks alone, what each client got and what the live rows hold."""

    def __init__(self, eng, traffic, tracker: Tracker, max_len: int):
        from repro_torch.serve.engine import Request

        self._Request = Request
        self.eng, self.traffic, self.tracker, self.max_len = eng, traffic, tracker, max_len
        self.reqs: dict[int, Req] = {}
        self.finished: list[int] = []
        self.prefill_lat: list[tuple[float, float]] = []  # (first token time, latency)
        self.t_first = time.perf_counter()
        tracker.ctx["live_rows"] = 0
        tracker.ctx["live_tokens"] = 0
        tracker.ctx["step"] = 0

    def start(self) -> None:
        self.t_first = time.perf_counter()
        for prompt, budget in self.traffic.first_round():
            self.submit(prompt, budget)

    def submit(self, prompt: np.ndarray, budget: int) -> None:
        budget = min(budget, self.max_len - len(prompt))
        rid = self.eng.submit(self._Request(prompt, max_new=budget))
        self.reqs[rid] = Req(prompt, budget, time.perf_counter())

    def on_token(self, rid: int, tok: int, idx: int, done: bool) -> None:
        now = time.perf_counter()
        r, ctx = self.reqs[rid], self.tracker.ctx
        r.stamps.append(now)
        r.tokens.append(tok)
        plen = len(r.prompt)
        if idx == 0:
            self.prefill_lat.append((now, now - self.tracker.last_start.get("prefill", now)))
            if not done:
                ctx["live_rows"] += 1
                ctx["live_tokens"] += plen + 1
        elif not done:
            ctx["live_tokens"] += 1
        if done:
            r.done = True
            self.finished.append(rid)
            if idx > 0:
                ctx["live_rows"] -= 1
                ctx["live_tokens"] -= plen + idx

    def step(self) -> None:
        self.tracker.ctx["step"] += 1
        self.eng.step(self.on_token)
        done, self.finished = self.finished, []
        for rid in done:
            self.eng.pop_result(rid)
        for prompt, budget in self.traffic.due(len(done), time.perf_counter() - self.t_first):
            self.submit(prompt, budget)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    import torch

    from repro_torch.serve.engine import Engine, RequestStatus

    dims = bmodel.dims(cell["model"])
    es = cell["run"]
    marks = [("start", t_start), ("import", time.perf_counter())]
    weights = bmodel.make_weights(cell["model"], seed, device)
    scfg = serve_config(cell["serve"])
    tracker = Tracker(ctx={"dims": dims}).install()
    try:
        eng = Engine(bmodel.port_config(cell["model"]), weights, scfg, device=device)
        gen = registry.generator(cell["mix"]["kind"]).make(cell["mix"], dims["vocab"], seed)
        drv = Driver(eng, gen, tracker, scfg.max_len)
        drv.start()
        btrace.sync(device)
        marks.append(("engine", time.perf_counter()))
        drv.step()
        btrace.sync(device)
        marks.append(("first step", time.perf_counter()))
        for _ in range(es["warmup_steps"] - 1):
            drv.step()
        btrace.sync(device)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print("setup: " + ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b)
                                    in zip(marks, marks[1:])), file=sys.stderr)
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's way in the window

        tracker.reset()
        drv.prefill_lat.clear()
        t0 = time.perf_counter()
        steps = 0
        while True:
            drv.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        gc.unfreeze()
        lat = window_latency(drv.reqs, t0, t1)
        host = SimpleNamespace(host_s=dict(tracker.host_s), calls=dict(tracker.calls))
        prefill_lat = [v for t, v in drv.prefill_lat if t0 <= t <= t1]

        summary, slice_ = None, None
        if trace:
            summary, slice_ = profiled_slice(drv, tracker, es["trace_steps"], device)
        failed = sum(1 for rid, r in drv.reqs.items() if t0 <= r.submitted <= t1 and not r.done
                     and eng.status(rid) in (RequestStatus.FAILED, RequestStatus.REJECTED,
                                             RequestStatus.CANCELLED))
        attempted = sum(1 for r in drv.reqs.values() if t0 <= r.submitted <= t1)
        done = [rid for rid, r in drv.reqs.items()
                if r.done and r.stamps and t0 <= r.stamps[-1] <= t1]
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        tracker.restore()
    reqs = drv.reqs
    del eng, drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(cell, weights, dims, reqs, done, seed, device)
    return {
        "e2e": {"setup_s": setup_s, "out_tok_s": lat["out_tok_s"],
                "ttft_p95_ms": lat["ttft_p95_ms"], "itl_p95_ms": lat["itl_p95_ms"]},
        "attempted": attempted, "failed": failed, "checks": checks,
        "memory_peak_bytes": int(peak), "trace": summary,
        "view": SimpleNamespace(kind="serve", window_s=t1 - t0, steps=steps,
                                prefill_lat=prefill_lat, **vars(host),
                                slice=slice_),
    }


def profiled_slice(drv: Driver, tracker: Tracker, steps: int, device):
    """``steps`` engine steps under the profiler: (trace summary, the
    slice's counts for the readers)."""
    summary = btrace.profile_steps(drv.step, steps, tracker, device)
    return summary, SimpleNamespace(
        window_s=summary["window_s"], steps=steps, calls=dict(tracker.calls),
        flops=dict(tracker.flops), bytes=dict(tracker.bytes), bound_s=dict(tracker.bound_s),
        host_s=dict(tracker.host_s), device_ms=summary["device_ms"], busy_s=summary["busy_s"])


def sample(done: list[int], reqs: dict[int, Req], n: int, seed: int) -> list[int]:
    """``n`` of the finished requests, drawn from the seed, the one with the
    most served tokens always among them."""
    if not done:
        return []
    longest = max(done, key=lambda rid: (len(reqs[rid].tokens), -rid))
    rest = sorted(set(done) - {longest})
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in pick]


def check(cell: dict, weights: dict, dims: dict, reqs: dict[int, Req], done: list[int],
          seed: int, device) -> dict:
    """The widest logit gap of the served tokens of a sample of the
    window's finished requests, against the float32 reference; also every
    sampled request holds its whole budget of in-vocabulary tokens."""
    import torch

    from bench.reference import lm

    lm.no_tf32()
    spec = cell["check"]
    picked = sample(done, reqs, spec["requests"], seed)
    widest, served, whole = 0.0, 0, True
    with torch.no_grad():
        for rid in picked:
            r = reqs[rid]
            toks = torch.tensor(r.tokens, dtype=torch.long, device=device)
            whole &= len(r.tokens) == r.budget and bool(((toks >= 0) & (toks < dims["vocab"])).all())
            if not whole:
                break
            rows = lm.served_rows(weights, dims, torch.from_numpy(r.prompt).long().to(device),
                                  toks)
            widest = max(widest, float(lm.gaps(rows, toks).max()))
            served += len(r.tokens)
    return {"logit_gap": {"value": widest, "limit": spec["logit_gap"]},
            "served_tokens": {"value": served, "limit": spec["min_served_tokens"],
                              "at_least": True},
            "bad_requests": {"value": 0 if whole else 1, "limit": 0}}
