"""Work of one paged decode-attention call
(``ops.decode_attention_paged(q, kpool, vpool, tables, lengths)``: one
layer, one query a row), from the call's own block tables.

Bytes: every physical block that a live row's table references within
the row's length is read once, however many rows share it (a shared
prefix's blocks count once), with the most tokens any row reads of it;
each live row's query is read and its output written once.  Operations:
two products of ``head_dim`` per key and query head of every live row
(sharing saves bytes, not products).  A row is live when its table's first
entry is not the sink block.  The tables and lengths are read back from
the card once a step (``ctx["step"]``; every layer of a step holds the same
ones), and only while the traced slice counts work."""

import numpy as np

SINK = 0  # the pool's garbage block, never owned by a row


def live_tokens(tables: np.ndarray, lengths: np.ndarray, block_size: int, num_blocks: int):
    """(live rows, their summed lengths, unique tokens read) of one call."""
    lengths = lengths.astype(np.int64)
    live = tables[:, 0] != SINK
    j = np.arange(tables.shape[1], dtype=np.int64)
    per = np.clip(lengths[:, None] - j[None, :] * block_size, 0, block_size)
    per = np.where(live[:, None] & (tables != SINK), per, 0)
    most = np.zeros(num_blocks, np.int64)
    np.maximum.at(most, tables.ravel().astype(np.int64), per.ravel())
    most[SINK] = 0
    return int(live.sum()), int(lengths[live].sum()), int(most.sum())


def count(ctx, args, kwargs):
    q, kpool, tables, lengths = args[0], args[1], args[3], args[4]
    step = ctx.get("step")
    memo = ctx.get("paged_attention_memo")
    if step is None or memo is None or memo[0] != step:
        memo = (step, *live_tokens(tables.cpu().numpy(), lengths.cpu().numpy(),
                                   kpool.shape[1], kpool.shape[0]))
        ctx["paged_attention_memo"] = memo
    _, rows, toks, unique = memo
    _, KV, G, hd = q.shape
    nbytes = 2 * unique * KV * hd * kpool.element_size() + 2 * rows * KV * G * hd * q.element_size()
    return 4.0 * toks * KV * G * hd, float(nbytes)
