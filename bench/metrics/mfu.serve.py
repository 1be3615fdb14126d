"""Percent of the card's bf16 peak the model's operations take over the
profiled steps: two per active parameter (top-k experts, not what the
batched product computes) for every token prefilled or decoded, the
unembedding of every token the program unembeds, and attention over each
token's live context."""

from bench.harness.view import mfu


def read(v):
    return mfu(v.slice, ("prefill", "decode_step"))
