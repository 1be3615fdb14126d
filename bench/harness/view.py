"""Helpers the per-layer metric readers share: a run's ``view`` holds the
window's host seconds and calls by span (``host_s``, ``calls``) and, in a
traced run, ``slice``: the profiled steps' calls, work counts (``flops``,
``bytes``, ``bound_s``), card milliseconds by range (``device_ms``),
``busy_s`` and ``window_s``."""

from bench.harness import peaks


def device_ms(sl, span: str) -> float:
    """Card ms of the kernels inside every range of ``span``, in any phase."""
    return sum(v for k, v in sl.device_ms.items() if k == span or k.startswith(span + "@"))


def roofline(sl, spans: tuple[str, ...]) -> float | None:
    """Percent: the least time the spans' work needs over the card time
    their kernels took (None when they did not run)."""
    if sl is None:
        return None
    ms = sum(device_ms(sl, s) for s in spans)
    bound = sum(sl.bound_s.get(s, 0.0) for s in spans)
    if ms <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ms / 1e3)


def mfu(sl, spans: tuple[str, ...]) -> float | None:
    """Percent: the model operations of the spans in the slice over the
    bf16 peak times the slice's length."""
    if sl is None or sl.busy_s <= 0:
        return None
    flops = sum(sl.flops.get(s, 0.0) for s in spans)
    return 100.0 * flops / (peaks.BF16_FLOPS_PER_S * sl.window_s) if flops > 0 else None


def idle(sl) -> float | None:
    """Percent of the slice with no kernel running."""
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
