"""The port's copy of the paper's analytic core (``repro/core``).

Loop nests, schedules, dataflows, the reuse and energy model, the batched
cost model, the blocking search, the exact simulator, the Halide-style
front end, the optimizer, the resource-allocation DSE, the TPU GEMM tile
mapper, the paper's network tables and the serve planner
(``serveplan``), as the reference has them (numpy only, no torch);
``tests/test_torch_core.py`` and ``tests/test_torch_core_dse.py`` hold them
to the reference bit for bit.  The H100's hierarchy the port's kernels
search on, and the serve planner's default hardware, are in
``repro_torch/hw.py``.  Public API re-exported as the reference's
``core/__init__.py`` does, less its seeded enumeration (``iter_blockings``),
which the port does not copy.
"""

from repro_torch.core.blocking import (
    SearchResult,
    enumerate_frontier,
    search_blocking,
)
from repro_torch.core.costmodel import (
    BatchedCostModel,
    BatchOverflowError,
    BatchReport,
    HierarchySweepReport,
)
from repro_torch.core.dataflow import Dataflow, enumerate_dataflows, make_dataflow
from repro_torch.core.dse import (
    DesignPoint,
    SweepCache,
    best_at_iso_throughput,
    pareto_prune,
    sweep_allocations,
)
from repro_torch.core.energy import CostTable, Report, evaluate
from repro_torch.core.loopnest import (
    LoopNest,
    TensorRef,
    conv_nest,
    depthwise_nest,
    fc_nest,
    matmul_nest,
)
from repro_torch.core.mapper import MatmulTiles, choose_matmul_tiles
from repro_torch.core.optimizer import (
    HardwareConfig,
    NetworkResult,
    evaluate_network,
    eyeriss_like,
    optimize_layer,
    optimize_network,
    tpu_like,
)
from repro_torch.core.reuse import AccessCounts, analyze
from repro_torch.core.schedule import ArraySpec, MemLevel, Schedule, flat_schedule
from repro_torch.core.simulate import simulate

__all__ = [
    "AccessCounts", "ArraySpec", "BatchOverflowError", "BatchReport",
    "BatchedCostModel", "CostTable", "Dataflow", "DesignPoint",
    "HardwareConfig", "HierarchySweepReport", "LoopNest", "MatmulTiles",
    "MemLevel", "NetworkResult", "Report", "Schedule", "SearchResult",
    "SweepCache", "TensorRef", "analyze", "best_at_iso_throughput",
    "choose_matmul_tiles", "conv_nest", "depthwise_nest",
    "enumerate_dataflows", "enumerate_frontier", "evaluate",
    "evaluate_network", "eyeriss_like", "fc_nest", "flat_schedule",
    "make_dataflow", "matmul_nest", "optimize_layer",
    "optimize_network", "pareto_prune", "search_blocking", "simulate",
    "sweep_allocations", "tpu_like",
]
