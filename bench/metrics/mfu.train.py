"""Percent of the card's bf16 peak the training steps' model operations
take over the profiled steps: six per parameter and token plus causal
attention (``bench.harness.train.train_flops``)."""

from bench.harness.view import mfu


def read(v):
    return mfu(v.slice, ("train_step",))
