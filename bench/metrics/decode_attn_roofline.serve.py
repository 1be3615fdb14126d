"""Percent of its roofline the decode-attention kernels reach over the
profiled steps: the least time their calls' work needs over the card time
of their kernels.  Paged calls count each physical block of keys and
values once, however many rows share it (``work/decode_attention_paged``);
contiguous calls each live row's keys and values; both the query and the
output once, and four operations per key, query head and head
dimension."""

from bench.harness.view import roofline


def read(v):
    return roofline(v.slice, ("decode_attention_paged", "decode_attention"))
