"""The readings the limits of ``correct`` are set from; not run by the
benchmark's own runs.

    python3 bench/calibrate.py --workload smollm-chat --seeds 11,12,13 --seconds 30

For each seed, one run of the cell as ``bench/run.py`` makes it (set-up,
window, the reference check), in one process, and beside the program's
numbers:

  * serving cells: the control, the reference with every projection's
    operands rounded to float8 (``precision="fp8"``) put in the program's
    place: at each position of the sampled requests' prompts and served
    tokens, the float32 reference's gap of the token the float8 logits put
    first, the widest over the sample;
  * training cells: the control (the float8 reference's three steps
    against the float32 reference's) and the fault of half the batch left
    out (the reference on the first half of every batch, the mean over
    those rows).  A state left unchanged reads 1 by the change's measure
    and needs no run.

One JSON line per seed on standard output; the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run  # noqa: E402  (puts src/ on sys.path, sets the cache dirs)
from bench.harness import registry, serve, train  # noqa: E402


def serve_control(cell, weights, dims, reqs, done, seed, device) -> dict:
    import torch

    from bench.reference import lm

    lm.no_tf32()
    picked = serve.sample(done, reqs, cell["check"]["requests"], seed)
    prog, ctrl = 0.0, 0.0
    with torch.no_grad():
        for rid in picked:
            r = reqs[rid]
            toks = torch.tensor(r.tokens, dtype=torch.long, device=device)
            prompt = torch.from_numpy(r.prompt).long().to(device)
            rows = lm.served_rows(weights, dims, prompt, toks)
            low = lm.served_rows(weights, dims, prompt, toks, precision="fp8")
            prog = max(prog, float(lm.gaps(rows, toks).max()))
            ctrl = max(ctrl, float(lm.gaps(rows, low.argmax(dim=-1)).max()))
    return {"program": {"logit_gap": prog}, "control": {"logit_gap": ctrl},
            "requests": len(picked)}


def train_control(cell, d, seed, device, batches, prog) -> dict:
    ref = train.reference(cell, d, seed, device, batches)
    low = train.reference(cell, d, seed, device, batches, precision="fp8")
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches[:3]]
    half_ref = train.reference(cell, d, seed, device, half)
    return {"program": train.compare(prog, ref), "control": train.compare(low, ref),
            "half_batch": train.compare(half_ref, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    cell = registry.cell(args.workload)
    found = {}
    if "serve" in cell:
        serve.check = lambda *a: found.update(serve_control(*a)) or {}
    else:
        train.check = lambda *a: found.update(train_control(*a)) or {}
    driver = serve if "serve" in cell else train
    for seed in (int(s) for s in args.seeds.split(",")):
        found.clear()
        out = driver.run(cell, seed, args.seconds, False, torch.device("cuda"), run.T_START)
        print(json.dumps({"seed": seed, **found, "e2e": out["e2e"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
