"""What a ``torch.profiler`` trace of the traced window says.

Kernels are the trace's device events, less the ``bench.*`` annotations
the profiler mirrors onto the device timeline.  From them:

  * ``busy_s``: the union of the kernels' intervals (the program's
    ``chip_smoke.busy_ms``, copied);
  * ``device_ms``: card milliseconds by ``bench.*`` range: every kernel
    counts for each range open on the host when the runtime call that
    launched it ran (the two share a correlation id), summed over the
    range's calls.  This holds for kernels launched through ``ctypes`` as
    for PyTorch's own, which the profiler's own op tree does not link;
  * ``device_ops``: the kernels that took most time, by name;
  * ``idle_gaps``: the card's idle time, split by what the host was doing
    meanwhile (the innermost ``bench.*`` range open on the host, or
    ``harness`` outside all of them).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "bench."
TOP = 10


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(ranges: list[tuple[str, int, int]], t0: int, t1: int):
    """The host timeline [t0, t1) cut into segments, each labelled by the
    innermost range open in it (ranges nest: they come from one thread)."""
    segs, stack, cur = [], [], t0

    def emit(upto: int) -> None:
        nonlocal cur
        upto = min(upto, t1)
        if upto > cur:
            segs.append((stack[-1][0] if stack else "harness", cur, upto))
            cur = upto

    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((name, e))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(t1)
    return segs


def idle_by_host(busy: list[tuple[int, int]], segs, t0: int, t1: int) -> dict[str, float]:
    """Seconds of [t0, t1) with no kernel running, by host segment label."""
    idle, cur = [], t0
    for s, e in busy:
        if s > cur:
            idle.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        idle.append((cur, t1))
    out: dict[str, float] = defaultdict(float)
    i = 0
    for label, s, e in segs:
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            lo, hi = max(s, idle[j][0]), min(e, idle[j][1])
            if hi > lo:
                out[label] += (hi - lo) / 1e9
            j += 1
    return dict(out)


def stacks(ranges: list[tuple[str, int, int]]) -> tuple[list[int], list[tuple[str, ...]]]:
    """The host timeline cut where any range opens or closes: the cut
    points, sorted, and the ranges open from each point to the next,
    outermost first (ranges nest: they come from one thread)."""
    ranges = [r for r in ranges if r[2] > r[1]]
    points = sorted({t for _, s, e in ranges for t in (s, e)})
    opened: dict[int, list[str]] = defaultdict(list)
    closed: dict[int, list[str]] = defaultdict(list)
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        opened[s].append(name)
        closed[e].append(name)
    out, stack = [], []
    for t in points:
        for name in closed[t]:
            stack.remove(name)
        stack.extend(opened[t])
        out.append(tuple(stack))
    return points, out


def attribute(kernels, ranges) -> dict[str, float]:
    """Card ms by range: each kernel's time counts for every range open on
    the host when it was launched (``kernels``: (name, start, end,
    launch_ns or None); a kernel with no known launch counts for none)."""
    points, opened = stacks(ranges)
    out: dict[str, float] = defaultdict(float)
    for _, s, e, launch in kernels:
        if launch is None:
            continue
        i = bisect.bisect_right(points, launch) - 1
        if i < 0:
            continue
        for name in opened[i]:
            out[name] += (e - s) / 1e6
    return dict(out)


def summarize_events(kernels, ranges) -> dict:
    """The summary from plain event lists: ``kernels`` (name, start_ns,
    end_ns, launch_ns) on the card, ``ranges`` (name, start_ns, end_ns)
    of ``bench.*`` ranges on the host."""
    busy = _union([(s, e) for _, s, e, _ in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e, _ in kernels:
        by_name[name] += (e - s) / 1e9
    points = [t for _, s, e, _ in kernels for t in (s, e)] + [t for _, s, e in ranges for t in (s, e)]
    t0, t1 = (min(points), max(points)) if points else (0, 0)
    segs = innermost([(n[len(PREFIX):], s, e) for n, s, e in ranges], t0, t1)
    idle = idle_by_host(busy, segs, t0, t1)
    device_ms = attribute(kernels, [(n[len(PREFIX):], s, e) for n, s, e in ranges])
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {
        "busy_s": busy_s,
        "device_ms": device_ms,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
        "launch_known": sum(1 for k in kernels if k[3] is not None) / max(len(kernels), 1),
    }


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...): torch's own operations
    are named ``aten::...``, the benchmark's ``bench....``."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        return "runtime" in kind or "driver" in kind
    return e.name().startswith("cu")


def summarize_kineto(events) -> dict:
    """:func:`summarize_events` of a profile's Kineto events.  A kernel's
    launch time is that of the runtime or driver call that launched it
    (the two share a correlation id), read from the host's clock."""
    from torch.autograd import DeviceType

    kernels, ranges, launches, ops = [], [], {}, {}
    for e in events:
        name, s = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX):
                kernels.append((name, s, s + e.duration_ns(), e.correlation_id(),
                                e.linked_correlation_id()))
        elif name.startswith(PREFIX):
            ranges.append((name, s, s + e.duration_ns()))
        elif _is_launch(e):
            launches[e.correlation_id()] = s
        else:
            ops[e.correlation_id()] = s
    # the launching call by correlation id, else the host operation the
    # profiler linked the kernel to
    kernels = [(n, s, e, launches.get(c, ops.get(lc) if lc else None))
               for n, s, e, c, lc in kernels]
    return summarize_events(kernels, ranges)


def summarize(prof) -> dict:
    """:func:`summarize_kineto` of a finished ``torch.profiler.profile``."""
    return summarize_kineto(prof.profiler.kineto_results.events())


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def profile_steps(step, steps: int, tracker, device) -> dict:
    """``steps`` calls of ``step`` under ``torch.profiler``, with the spans'
    ranges and work counts on (counts reset first): the trace's summary,
    with ``window_s``, the steps' host seconds between two waits for the
    card.  On the CPU the summary has no kernels."""
    import time

    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tracker.reset()
    tracker.profiling = tracker.counting = True
    sync(device)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync(device)
            window_s = time.perf_counter() - t0
    finally:
        tracker.profiling = tracker.counting = False
    summary = summarize(prof) if cuda else summarize_events([], [])
    summary["window_s"] = window_s
    return summary
