"""Quickstart on the PyTorch/CUDA port: the paper's workflow end to end.

1. Describe a CONV layer as the seven-loop nest (paper Algorithm 1).
2. Pick a dataflow (spatial unrolling) and hardware (memory hierarchy).
3. Search loop blockings with the analytical model; inspect the schedule.
4. Cross-check the model against the exact simulator.
5. Map the same machinery to the H100: the K split of a decode GEMM and
   the tile of a CONV layer, as the port's CUDA kernels take them.

Imports only ``repro_torch`` (step 5 imports torch; no card is needed).

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""

import dataclasses

from repro_torch.core import (
    ArraySpec,
    MemLevel,
    analyze,
    conv_nest,
    make_dataflow,
    search_blocking,
    simulate,
)

# 1. the algorithm: AlexNet CONV3 as a loop nest
nest = conv_nest("conv3", B=16, K=384, C=256, X=13, Y=13, FX=3, FY=3)
print(f"nest: {dict(nest.bounds)}  MACs={nest.macs()/1e9:.2f}G")

# 2. hardware skeleton (Eyeriss-like) + C|K dataflow with replication
levels = (
    MemLevel("RF", 512, double_buffered=False, per_pe=True),
    MemLevel("BUF", 128 * 1024),
    MemLevel("DRAM", None),
)
array = ArraySpec(dims=(16, 16))
dataflow = make_dataflow(nest, array, ("C", "K"))
print("dataflow:", dataflow.label(), "PEs used:", dataflow.used_pes())

# 3. blocking search (the paper's schedule optimization)
result = search_blocking(nest, levels, array, dataflow, beam=8)
report = result.best
print(f"best energy: {report.energy_pj/1e6:.0f} uJ  "
      f"utilization: {report.utilization:.2f}")
print(report.schedule.describe())
print("breakdown (uJ):",
      {k: round(v / 1e6, 1) for k, v in report.breakdown_pj.items()})

# 4. validate the analytical model against the exact simulator
#    (fold the spatial dims into the top level for the temporal simulator)
sched = report.schedule
temporal = dataclasses.replace(
    sched,
    tiling={
        d: tuple(
            f * (sched.spatial_factor(d) if i == len(levels) - 1 else 1)
            for i, f in enumerate(sched.tiling[d])
        )
        for d in nest.dims
    },
    array=ArraySpec(dims=(1,)),
    spatial=((),),
)
assert analyze(temporal).reads == simulate(temporal).reads
print("analytical model == exact simulator: OK")

# 5. the same blocking engine on the H100's hierarchy (repro_torch/hw.py):
#    the GEMM kernel's K split for smollm-360m's MLP down projection at
#    decode, and the bf16 conv kernel's tile for this layer
from repro_torch.kernels.conv2d.ops import conv_search  # noqa: E402
from repro_torch.kernels.matmul import matmul as mm  # noqa: E402
from repro_torch.kernels.matmul.ops import gemm_search  # noqa: E402

split = gemm_search(N=960, K=2560)
plan = mm.plan(8, 960, 2560)
print(f"H100 GEMM (8x960x2560): K split {split.split} by the search, "
      f"{plan.split} in the kernel's plan ({plan.body} body, {plan.grid} blocks, "
      f"{plan.stages} stages, {plan.smem} B shared memory)")
conv = conv_search(16, 13, 13, 256, 384, 3, 3)
t = conv.tiles
print(f"H100 conv tile for conv3: {t.nb} image(s) x {t.bx}x{t.by} pixels, "
      f"bc={t.bc} bk={t.bk}, {t.stages} ring stages, "
      f"utilization {conv.report.utilization:.2f}")
