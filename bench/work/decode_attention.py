"""Work of one decode-attention call (one layer, one query a row), from
each live row's length as the driver knows it (``ctx["live_rows"]``,
``ctx["live_tokens"]``: the rows holding a request and their summed
lengths, the new token's key included): every live key and value read
once, each row's query read and output written once; two products of
``head_dim`` per key and query head."""


def count(ctx, args, kwargs):
    d = ctx["dims"]
    q = args[0]
    H, KV, hd = d["heads"], d["kv_heads"], d["head_dim"]
    esz = q.element_size()
    rows, toks = ctx["live_rows"], ctx["live_tokens"]
    nbytes = 2 * toks * KV * hd * esz + 2 * rows * H * hd * esz
    return 4.0 * toks * H * hd, float(nbytes)
