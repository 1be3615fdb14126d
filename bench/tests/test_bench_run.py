"""A whole run of every cell at a CPU test's size: set-up, window, traced
slice and the reference check, through ``run.execute`` (which skips the
look for a card)."""

from __future__ import annotations

import pytest
import torch

from bench import run

CELLS = ["smollm-chat", "granite-moe-chat", "smollm-train"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny_bench, workload, trace):
    out = run.execute(workload, seed=2**31 + 11, seconds=0.5, trace=trace,
                      device=torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if not trace:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) >= 2
    else:
        # on the CPU only the host's spans read; no device metric is made up
        from bench.harness import registry

        spans = {m["name"] for m in registry.per_layer_metrics(workload)
                 if m["source"] == "program_span"}
        assert set(out["metrics"]) == spans
