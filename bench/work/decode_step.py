"""Model operations of one decode step: for every live row, two per
parameter it multiplies by (a mixture of experts counts its router and
top-k experts, not what its batched product computes) and the tied
unembedding, plus attention over the row's live context in every layer.
No byte count: the step's share of the peak is an operations share."""

from bench.harness.model import param_counts


def count(ctx, args, kwargs):
    d = ctx["dims"]
    p = param_counts(d)
    rows, toks = ctx["live_rows"], ctx["live_tokens"]
    per_row = 2.0 * (d["layers"] * p["layer_active"] + p["unembed"])
    attn = 4.0 * d["layers"] * d["heads"] * d["head_dim"] * toks
    return rows * per_row + attn, 0.0
