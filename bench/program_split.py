"""A training cell's traced slice split by the program's own ranges; not
run by the benchmark's own runs.

    python3 bench/program_split.py --workload smollm-train --seed 7 --seconds 10

From the root of a checkout, on a card.  The run is ``bench/run.py
--trace 1``'s (set-up, a window of ``--seconds``, the profiled slice, the
check); the program opens its ranges, ``repro_torch.*``, while the
profiler records (``repro_torch/obs.py``: the step's phases, and the
model's regions suffixed ``@forward``, ``@recompute`` or ``@backward``).
From the slice's events, beside the run's metrics and checks, one JSON
line on standard output:

  * ``program_ms``: card ms a step by the innermost program range open
    when each kernel was launched (the ranges' self times: they partition
    the kernels launched under any of them), largest first;
  * ``groups``: their sums a step: ``fwd`` (``forward`` and every
    ``*@forward``), ``bwd`` (``backward`` and every ``*@backward``),
    ``remat`` (every ``*@recompute``), ``attn`` (``attention@*``), ``head``
    (``head@*``), ``optim`` (``clip`` and ``adamw``);
  * ``under_program``: the share of the slice's kernel time launched under
    some program range;
  * ``idle_gaps``: the card's idle seconds in the slice by the innermost
    range of either kind (``bench.*`` or the program's) open on the host;
  * ``mirrored``: device events named as a program range (0: the profiler
    mirrors none, so the benchmark's own summary counts none as a kernel).

The card's name and power limit come first.  The benchmark's result line
does not read the program's ranges yet (``PERF.md``, Open questions).
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run  # noqa: E402  (puts src/ on sys.path, sets the cache dirs)
from bench.harness import trace as btrace  # noqa: E402

PROGRAM = "repro_torch."
GROUPS = {
    "fwd": lambda n: n == "forward" or n.endswith("@forward"),
    "bwd": lambda n: n == "backward" or n.endswith("@backward"),
    "remat": lambda n: n.endswith("@recompute"),
    "attn": lambda n: n.startswith("attention@"),
    "head": lambda n: n.startswith("head@"),
    "optim": lambda n: n in ("clip", "adamw"),
}


def program_ranges(events) -> list[tuple[str, int, int]]:
    """(name less ``repro_torch.``, start_ns, end_ns) of the program's
    ranges among a profile's host events, from every thread."""
    from torch.autograd import DeviceType

    return [(e.name()[len(PROGRAM):], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events
            if e.name().startswith(PROGRAM) and e.device_type() != DeviceType.CUDA]


def split(kernels, ranges, program, steps: int) -> dict:
    """The split of a slice: ``kernels`` (name, start_ns, end_ns,
    launch_ns or None) and ``ranges`` as ``trace.summarize_events`` takes
    them, ``program`` as :func:`program_ranges` gives them (they nest in
    time: the backward's, on autograd's thread, run while the thread that
    opened ``backward`` waits)."""
    points, opened = btrace.stacks(program)
    own: dict[str, float] = defaultdict(float)
    for _, s, e, launch in kernels:
        i = -1 if launch is None else bisect.bisect_right(points, launch) - 1
        if i >= 0 and opened[i]:
            own[opened[i][-1]] += (e - s) / 1e6
    kernel_ms = sum(e - s for _, s, e, _ in kernels) / 1e6
    both = [(n[len(btrace.PREFIX):], s, e) for n, s, e in ranges] + list(program)
    ts = [t for _, s, e, _ in kernels for t in (s, e)] + [t for _, s, e in both for t in (s, e)]
    t0, t1 = (min(ts), max(ts)) if ts else (0, 0)
    busy = btrace._union([(s, e) for _, s, e, _ in kernels])
    idle = btrace.idle_by_host(busy, btrace.innermost(both, t0, t1), t0, t1)
    return {
        "program_ms": {k: v / steps for k, v in sorted(own.items(), key=lambda kv: -kv[1])},
        "groups": {g: sum(v for k, v in own.items() if test(k)) / steps
                   for g, test in GROUPS.items()},
        "under_program": sum(own.values()) / kernel_ms if kernel_ms else 0.0,
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])],
    }


def capture() -> dict:
    """Have the trace summary keep what it reads: the program's ranges and
    the kernel and ``bench.*`` lists it builds (the summary is unchanged)."""
    seen: dict = {}
    kineto, summarize_events = btrace.summarize_kineto, btrace.summarize_events

    def keep_program(events):
        from torch.autograd import DeviceType

        events = list(events)
        seen["program"] = program_ranges(events)
        # the summary would count a program range mirrored on the card as a
        # kernel; the program's ranges are of a kind the profiler does not mirror
        seen["mirrored"] = sum(1 for e in events if e.device_type() == DeviceType.CUDA
                               and e.name().startswith(PROGRAM))
        return kineto(events)

    def keep_lists(kernels, ranges):
        seen["kernels"], seen["ranges"] = kernels, ranges
        return summarize_events(kernels, ranges)

    btrace.summarize_kineto, btrace.summarize_events = keep_program, keep_lists
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("program_split: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    seen = capture()
    out = run.execute(args.workload, args.seed, args.seconds, True, torch.device("cuda"))
    sl = out["view"].slice
    line = {"workload": args.workload, "seed": args.seed, "correct": bool(out["correct"]),
            "metrics": out["metrics"], "busy_s": sl.busy_s, "window_s": sl.window_s,
            "steps": sl.steps, "mirrored": seen["mirrored"],
            **split(seen["kernels"], seen["ranges"], seen["program"], sl.steps),
            "checks": out["checks"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
