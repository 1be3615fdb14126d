"""Design-space exploration on the port: the paper's efficient optimizer (§6.3).

Runs the Obs1+Obs2-pruned hardware x blocking search for a DNN and prints
the optimized accelerator config + energy vs the Eyeriss-like baseline --
examples/torch_quickstart.py at network scale, on the port's own copy of
the paper's core (``repro_torch.core``, numpy only).  The accelerators are
the paper's abstract ones, not the H100.

Run:  PYTHONPATH=src python examples/torch_optimize_accelerator.py [--net alexnet]
"""

import argparse

from repro_torch.core import ArraySpec, eyeriss_like
from repro_torch.core.networks import PAPER_BENCHMARKS
from repro_torch.core.optimizer import candidate_hierarchies, evaluate_network


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="alexnet", choices=sorted(PAPER_BENCHMARKS))
    ap.add_argument("--evals", type=int, default=800)
    args = ap.parse_args()

    layers = PAPER_BENCHMARKS[args.net]()
    base_hw = eyeriss_like()
    base = evaluate_network(layers, base_hw, args.evals)
    print(f"{args.net}: baseline ({base_hw.name}) "
          f"energy={base.total_energy_pj/1e6:.0f} uJ "
          f"TOPs/W={base.tops_per_watt():.2f}")

    best = None
    for hw in candidate_hierarchies(ArraySpec(dims=(16, 16)),
                                    two_level_rf=False):
        try:
            res = evaluate_network(layers, hw, args.evals)
        except ValueError:
            continue
        if best is None or res.total_energy_pj < best.total_energy_pj:
            best = res
            print(f"  new best: {hw.name:20s} "
                  f"{res.total_energy_pj/1e6:.0f} uJ "
                  f"({base.total_energy_pj/res.total_energy_pj:.2f}x)")
    print(f"optimized: {best.hw.name}  "
          f"gain={base.total_energy_pj/best.total_energy_pj:.2f}x  "
          f"TOPs/W={best.tops_per_watt():.2f}")
    # per-layer winning schedules
    for lr in best.layers[:3]:
        print(f"--- {lr.nest.name}: {lr.dataflow.label()}")
        print(lr.report.schedule.describe())


if __name__ == "__main__":
    main()
