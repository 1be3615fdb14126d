"""The ``pretrain`` traffic generator (training): a mix file with
``"kind": "pretrain"`` is read here.

Batches of ``rows`` sequences of ``seq_len`` tokens, each token either
uniform over the vocabulary or, with probability ``structure``, a fixed
function of the one before (so a loss can fall), every row drawn apart
from the seed.  The same rule as the port's synthetic data pipeline, kept
here so that the benchmark makes its own inputs.

A training generator gives :func:`batches` ``(mix, vocab, seed, n)``.
"""

from __future__ import annotations

import numpy as np


def batches(mix: dict, vocab: int, seed: int, n: int) -> list[dict]:
    """``n`` batches: ``tokens`` and ``labels``, each ``(rows, seq_len)``
    int64, the labels the tokens shifted by one."""
    if mix["kind"] != "pretrain":
        raise ValueError(f"not a pretraining mix: {mix['kind']!r}")
    rows, T, s = mix["rows"], mix["seq_len"], float(mix["structure"])
    out = []
    for step in range(n):
        rng = np.random.default_rng([int(seed) % (1 << 63), 2, step])
        toks = rng.integers(0, vocab, (rows, T + 1), dtype=np.int64)
        if s > 0:
            nxt = (toks[:, :-1] * 31 + 7) % vocab
            keep = rng.random((rows, T)) < s
            toks[:, 1:] = np.where(keep, nxt, toks[:, 1:])
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out
