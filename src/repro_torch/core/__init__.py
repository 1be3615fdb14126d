"""The port's copy of the paper's analytic core (``repro/core``).

Loop nests, schedules, the reuse and energy model, the batched cost model,
the blocking search, the TPU GEMM tile mapper and the paper's CNN tables,
as the reference has them (numpy only); ``tests/test_torch_core.py`` holds
them to the reference bit for bit.  The H100's hierarchy they search on
for the port's kernels is in ``repro_torch/hw.py``.
"""
