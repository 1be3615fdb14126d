"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload smollm-chat --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell, its configuration and its traffic
mix are found by name under ``bench/`` (``bench/harness/registry.py``);
``BENCHMARK.json`` says which metrics the cell reports: its end-to-end
metrics with ``--trace 0``, its per-layer metrics (each read by
``bench/metrics/<name>.py``) with ``--trace 1``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared with its limit), and the same checks are
the last lines of standard error.

The process keeps to one compute thread (``OMP_NUM_THREADS`` and torch's
intra-op pool).  The run needs as many CUDA devices as the cell asks for and exits with
code 2 and no result without them.  It exits with code 3 and no result if
JAX, jaxlib, flax or the JAX package ``repro`` was loaded by the time the
window closed.  Kernel builds and caches stay inside the checkout
(``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one process with one compute thread: the engine's loop is single-threaded
# Python, and idle pool threads only add jitter to a host-bound run
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

from bench.harness import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's or the JAX package's (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``workload`` on ``device``: the driver's result with the
    cell's metrics read (no device check; the tests call this on the CPU)."""
    cell = registry.cell(workload)
    if "serve" in cell:
        from bench.harness import serve as driver
    else:
        from bench.harness import train as driver
    out = driver.run(cell, seed, seconds, trace, device, T_START)
    metrics = {}
    if trace:
        for m in registry.per_layer_metrics(workload):
            value = registry.load_module("metrics", m["name"]).read(out["view"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in registry.end_to_end_metrics(workload):
            value = out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out["metrics"] = metrics
    out["correct"] = judge(out["checks"]) and out["failed"] == 0
    return out


def judge(checks: dict) -> bool:
    """Every number within its limit (``at_least``: at or above it)."""
    ok = True
    for c in checks.values():
        v = c["value"]
        if not math.isfinite(v):
            ok = False
        elif c.get("at_least"):
            ok &= v >= c["limit"]
        else:
            ok &= v <= c["limit"]
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    entry = registry.workload_entry(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"bench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"))
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if args.trace:
        tr = out["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        print(f"trace: {100 * tr['launch_known']:.1f}% of kernels with a known launch; "
              f"card ms by span {tr['device_ms']}", file=sys.stderr)
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']!r} (limit {rel} {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
