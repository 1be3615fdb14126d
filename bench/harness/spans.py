"""Spans around the calls into the program's layers, taken from outside.

Each file ``bench/spans/<name>.json`` names one call::

    {"target": "repro_torch.arch.transformer:Model.decode_step",
     "phase": true, "work": "decode_step"}

``target`` is a module and an attribute path in it; the harness replaces
that attribute by a wrapper, so the program's own code, which looks the
attribute up at call time, calls through it.  The wrapper adds the host
seconds of every call to its span (issue time: nothing here waits for the
card), and while the profiler runs it opens a ``record_function`` range
``bench.<name>``, suffixed ``@<phase>`` with the nearest enclosing span
marked ``phase`` (so the MoE layer's kernels in a decode step are told
from those in a prefill).  ``work`` names ``bench/work/<work>.py``, whose
``count(ctx, args, kwargs)`` gives the operations and bytes the call needs;
it runs only while the tracker counts (the traced window), and adds them
to the same name.  This is the ``HostTimer`` pattern of the program's
``chip_smoke.py``, widened to nesting, ranges and work.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict

from bench.harness import registry


def resolve(target: str):
    """(owner, attribute) of ``"module:Attr.path"``."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parts, attr = path.split(".")
    for part in parts:
        owner = getattr(owner, part)
    return owner, attr


class Tracker:
    """Host seconds, calls and work by span, and the context the work
    counts read (``ctx``: sizes, and what the driver knows of the live
    requests)."""

    def __init__(self, defs: dict | None = None, ctx: dict | None = None):
        self.defs = registry.spans() if defs is None else defs
        self.ctx = {} if ctx is None else ctx
        self.profiling = False
        self.counting = False
        self.stack: list[str] = []
        self.last_start: dict[str, float] = {}
        self._saved = []
        self._work = {}
        self.reset()

    def reset(self) -> None:
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self.flops = defaultdict(float)
        self.bytes = defaultdict(float)
        self.bound_s = defaultdict(float)

    def install(self) -> "Tracker":
        for name, spec in self.defs.items():
            owner, attr = resolve(spec["target"])
            fn = getattr(owner, attr)
            if spec.get("work"):
                self._work[name] = registry.load_module("work", spec["work"]).count
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, spec, fn))
        return self

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def _phase(self) -> str | None:
        for name in reversed(self.stack):
            if self.defs[name].get("phase"):
                return name
        return None

    def _wrap(self, name: str, spec: dict, fn):
        tracker = self
        work = self._work.get(name)

        def wrapped(*args, **kwargs):
            ctx = contextlib.nullcontext()
            if tracker.profiling:
                import torch

                phase = tracker._phase()
                ctx = torch.profiler.record_function(
                    f"bench.{name}" + (f"@{phase}" if phase and phase != name else ""))
            t = time.perf_counter()
            tracker.last_start[name] = t
            tracker.stack.append(name)
            try:
                with ctx:
                    return fn(*args, **kwargs)
            finally:
                tracker.stack.pop()
                tracker.host_s[name] += time.perf_counter() - t
                tracker.calls[name] += 1
                if work is not None and tracker.counting:
                    fl, by = work(tracker.ctx, args, kwargs)
                    tracker.flops[name] += fl
                    tracker.bytes[name] += by
                    tracker.bound_s[name] += bound_s(fl, by)

        wrapped.__wrapped__ = fn
        return wrapped


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the work can take on the card: the larger of its
    operations over the bf16 tensor-core peak and its bytes over the HBM
    rate (``bench.harness.peaks``)."""
    from bench.harness import peaks

    return max(flops / peaks.BF16_FLOPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
