"""Profiler ranges inside the training step: its phases and the model's
regions, on the profiler's own clock.

Every range is a profiler range named ``repro_torch.<name>`` and exists
only while a torch profiler records (torch's own flag), so any profiler
trace of a step (Chrome, TensorBoard) shows them beside the operations
and kernels they launched.  They are function-scope ranges (``cpu_op``
events, as torch's own operations are), not ``record_function``'s user
annotations: the profiler mirrors no copy of them onto the device
timeline, so a trace's device events are the kernels alone, with the
ranges or without.  With no profiler recording a phase is one flag check
that returns a shared null context, and a region one flag check before
it calls its function as it is: no clock reading, no allocation.

Phases (:func:`phase`), set by ``train/loop.py`` and ``train/optim.py``:
``forward`` (the loss), ``backward`` (``torch.autograd.grad``),
``grad_sum`` (the fp32 sum of the microbatches' gradients), ``clip`` and
``adamw``.  The phase is process-wide, not per thread: autograd's device
thread runs the backward, and the regions it reruns read the phase too.

Regions (:func:`region`, a decorator on the model's parts: ``embed``,
``norm``, ``attn_proj``, ``attention``, ``mlp``, ``head``, ``layer``)
open a range named with the phase: ``<region>@forward`` in the forward,
``<region>@recompute`` when ``torch.utils.checkpoint`` reruns the region
in the backward; outside those two phases they open none.  The first
forward also places identity markers (autograd functions) at the
region's tensor inputs and outputs that need a gradient: the one at its
outputs opens ``<region>@backward`` when their gradients have arrived,
the one at its inputs closes it when their gradients are done.  The
markers pass values and gradients through untouched, and are placed only
while a profiler records, so without one the autograd graph is the
model's own.  Backward ranges close innermost first, so they nest; one
still open when ``backward`` ends (its input's gradient never came, or
the region has no input that needs one) is closed then.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
_NULL = contextlib.nullcontext()


class _State:
    """The step's phase and the backward ranges open, innermost last.
    One per process (see the module's docstring)."""

    def __init__(self):
        self.phase: str | None = None
        self.open: list[_Range] = []


_STATE = _State()


def _range(name: str):
    """The range ``repro_torch.<name>``, a function-scope one."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def phase(name: str):
    """A context that sets the step's phase to ``name`` and opens its
    range, while a profiler records; else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _phase(name)


@contextlib.contextmanager
def _phase(name: str):
    prev = _STATE.phase
    _STATE.phase = name
    try:
        with _range(name):
            try:
                yield
            finally:
                if name == "backward":
                    _close_to(None)
    finally:
        _STATE.phase = prev


class _Range:
    """One region call's backward range, opened by its output marker."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None


def _close_to(rng: _Range | None) -> None:
    """Close the open backward ranges from the innermost out, down to and
    with ``rng`` (all of them for None; nothing if ``rng`` is not open)."""
    if rng is not None and rng not in _STATE.open:
        return
    while _STATE.open:
        top = _STATE.open.pop()
        top.rf.__exit__(None, None, None)
        if top is rng:
            return


class _Exit(torch.autograd.Function):
    """Identity on a region's outputs; its backward, run once their
    gradients have all arrived, opens the region's backward range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        rng = ctx.rng
        if _profiler._is_profiler_enabled and rng.rf is None:
            rng.rf = _range(f"{rng.name}@backward")
            rng.rf.__enter__()
            _STATE.open.append(rng)
        return (None, *grads)


class _Enter(torch.autograd.Function):
    """Identity on a region's inputs; its backward, run once their
    gradients are done, closes the region's backward range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _close_to(ctx.rng)
        return (None, *grads)


def _marked(marker, rng: _Range, items: list) -> list:
    """``items`` with each tensor that needs a gradient passed through
    one call of ``marker``.  A tensor given twice gets one view, so its
    uses' gradients are summed in the order they are without markers."""
    uniq = {}
    for x in items:
        if isinstance(x, torch.Tensor) and x.requires_grad:
            uniq.setdefault(id(x), x)
    if not uniq:
        return items
    views = dict(zip(uniq, marker.apply(rng, *uniq.values())))
    return [views.get(id(x), x) for x in items]


def _forward(name: str, fn, args: tuple, kwargs: dict):
    with _range(f"{name}@forward"):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        rng = _Range(name)
        keys = list(kwargs)
        given = _marked(_Enter, rng, [*args, *kwargs.values()])
        out = fn(*given[:len(args)], **dict(zip(keys, given[len(args):])))
        if isinstance(out, tuple):
            return tuple(_marked(_Exit, rng, list(out)))
        return _marked(_Exit, rng, [out])[0]


def region(name: str):
    """Decorator: the function is the model's region ``name`` (see the
    module's docstring)."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            ph = _STATE.phase
            if ph == "forward":
                return _forward(name, fn, args, kwargs)
            if ph == "backward":
                with _range(f"{name}@recompute"):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return wrapped

    return wrap
