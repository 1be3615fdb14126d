"""Percent of its roofline the hand-written GEMM reaches behind
``ops.matmul``: the sum over its calls of the least time each needs (the
larger of its bytes over the HBM rate and 2MNK over the bf16 peak) over
the card time of its kernels (profiled steps, prefill and decode)."""

from bench.harness.view import roofline


def read(v):
    return roofline(v.slice, ("matmul",))
