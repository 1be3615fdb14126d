"""Model operations of one admission prefill of ``n`` prompts of ``T``
tokens (``Model.prefill(params, tokens (n, T), ...)``): two per active
parameter and token in every layer, causal attention over each prompt
(T(T+1)/2 query-key pairs), and the tied unembedding of each prompt's
last token, which is all the program unembeds."""

from bench.harness.model import param_counts


def count(ctx, args, kwargs):
    d = ctx["dims"]
    p = param_counts(d)
    tokens = args[2] if len(args) > 2 else kwargs["tokens"]
    n, T = tokens.shape
    layers = 2.0 * d["layers"] * p["layer_active"] * T
    attn = 4.0 * d["layers"] * d["heads"] * d["head_dim"] * T * (T + 1) / 2
    return n * (layers + attn + 2.0 * p["unembed"]), 0.0
