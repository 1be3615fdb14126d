"""The trace reading on synthetic events: busy time, card time by range
(from each kernel's launch), idle time by what the host was doing, and the
join of kernels to their launching calls."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType

from bench.harness import trace


def test_busy_union_and_idle_by_host():
    # host: engine_step [0, 100) holding decode_step [10, 60) holding matmul [20, 30)
    ranges = [("bench.engine_step", 0, 100), ("bench.decode_step", 10, 60),
              ("bench.matmul@decode_step", 20, 30)]
    kernels = [("gemm", 25, 40, 22), ("add", 35, 45, 50), ("argmax", 80, 90, 70)]
    out = trace.summarize_events(kernels, ranges)
    assert out["busy_s"] == pytest.approx((45 - 25 + 90 - 80) / 1e9)
    # idle: [0,25) -> engine 10 + decode 10 + matmul 5; [45,80) -> decode 15 + engine 20;
    # [90,100) -> engine 10
    idle = dict(out["idle_gaps"])
    assert idle["engine_step"] == pytest.approx(40 / 1e9)
    assert idle["decode_step"] == pytest.approx(25 / 1e9)
    assert idle["matmul@decode_step"] == pytest.approx(5 / 1e9)
    # card time by range counts a kernel for every range open at its launch
    ms = out["device_ms"]
    assert ms["matmul@decode_step"] == pytest.approx(15 / 1e6)
    assert ms["decode_step"] == pytest.approx(25 / 1e6)
    assert ms["engine_step"] == pytest.approx(35 / 1e6)
    assert dict(out["device_ops"])["gemm"] == pytest.approx(15 / 1e9)


def test_a_kernel_with_no_known_launch_counts_for_no_range():
    out = trace.summarize_events([("k", 5, 9, None)], [("bench.a", 0, 10)])
    assert out["device_ms"] == {} and out["launch_known"] == 0


class _Ev:
    def __init__(self, name, dev, s, d, corr, linked=0, kind="cpu_op"):
        self._v = (name, dev, s, d, corr, linked, kind)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def activity_type(self): return self._v[6]


def test_kernels_join_their_launching_call_by_correlation():
    evs = [
        _Ev("bench.matmul", DeviceType.CPU, 100, 50, 7, kind="user_annotation"),
        _Ev("cudaLaunchKernelExC", DeviceType.CPU, 120, 5, 901, kind="cuda_runtime"),
        _Ev("gemm_tc_kernel", DeviceType.CUDA, 300, 40, 901, kind="kernel"),
        _Ev("bench.matmul", DeviceType.CUDA, 300, 40, 7, kind="gpu_user_annotation"),
        # a kernel whose launch is missing, linked to a host op outside the range
        _Ev("aten::add", DeviceType.CPU, 200, 5, 11),
        _Ev("add_kernel", DeviceType.CUDA, 400, 10, 999, linked=11, kind="kernel"),
    ]
    out = trace.summarize_kineto(evs)
    assert out["device_ms"] == {"matmul": pytest.approx(40 / 1e6)}
    assert out["busy_s"] == pytest.approx(50 / 1e9)
    assert out["launch_known"] == 1.0


def test_summarize_reads_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.x"):
            torch.ones(4).sum()
    out = trace.summarize(prof)
    assert out["busy_s"] == 0 and out["device_ops"] == []
