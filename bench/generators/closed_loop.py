"""The ``closed_loop`` traffic generator (serving): a mix file
(``bench/traffic/<mix>.json``) with ``"kind": "closed_loop"`` is read here.

``clients`` clients, each sending its next request the moment its previous
one finishes.  A request is an optional shared system prompt (one of
``shared_prefixes.count`` prompts of ``shared_prefixes.tokens`` tokens,
picked by a Zipf rank with exponent ``zipf_s``), then a prompt of its own,
then an output budget.  The sizes (which prefix, the prompt's and the
output's lengths) form a fixed sequence of ``pool`` requests drawn from
``sizes_seed``, the same for every run seed and sent in the same order (a
window sees only part of the pool, so another order would give it other
work); the run's seed draws the token ids.  Lengths are log-normal around
``median`` with spread ``sigma``, rounded and clipped to ``[min, max]``.
The clients' first requests are cut to staggered shares of their budgets
(client ``i`` of ``n`` gets ``(i + 1) / n`` of it), so completions are
spread out from the first step, as in a loop that has been running.

A serving generator gives :func:`make` ``(mix, vocab, seed)``, whose
result has ``first_round()``, the requests at the window's start, and
``due(finished, elapsed_s)``, the requests to send after an engine step
in which ``finished`` requests ended, ``elapsed_s`` seconds after the
first round; each request is ``(prompt, budget)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _seed(seed: int) -> int:
    """Any whole number as a non-negative seed (numpy takes no negatives)."""
    return int(seed) % (1 << 63)


@dataclasses.dataclass(frozen=True)
class Sizes:
    prefix: np.ndarray   # (pool,) shared prompt index, -1 for none
    own: np.ndarray      # (pool,) tokens of the request's own prompt
    out: np.ndarray      # (pool,) output budget


def pool_sizes(mix: dict) -> Sizes:
    """The mix's fixed pool of request sizes (independent of the run seed)."""
    rng = np.random.default_rng(mix["sizes_seed"])
    n = mix["pool"]
    sp = mix.get("shared_prefixes") or {"count": 0}
    if sp["count"]:
        ranks = np.arange(1, sp["count"] + 1, dtype=np.float64)
        p = ranks ** -float(sp["zipf_s"])
        prefix = rng.choice(sp["count"], size=n, p=p / p.sum())
    else:
        prefix = np.full(n, -1)
    return Sizes(prefix=prefix, own=_lengths(rng, mix["prompt"], n),
                 out=_lengths(rng, mix["output"], n))


class ClosedLoop:
    """The requests of a ``closed_loop`` mix for one seed: :meth:`first_round`
    gives every client's first request, :meth:`next` each one after."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix["kind"] != "closed_loop":
            raise ValueError(f"not a closed-loop mix: {mix['kind']!r}")
        self.mix, self.vocab, self.seed = mix, vocab, _seed(seed)
        self.sizes = pool_sizes(mix)
        rng = np.random.default_rng([self.seed, 0])
        sp = mix.get("shared_prefixes") or {"count": 0}
        self.prefixes = [rng.integers(0, vocab, sp["tokens"], dtype=np.int32)
                         for _ in range(sp["count"])]
        self.clients = int(mix["clients"])
        self._i = 0

    def _request(self, i: int) -> tuple[np.ndarray, int]:
        j = i % len(self.sizes.out)
        rng = np.random.default_rng([self.seed, 1, i])
        own = rng.integers(0, self.vocab, int(self.sizes.own[j]), dtype=np.int32)
        k = int(self.sizes.prefix[j])
        prompt = own if k < 0 else np.concatenate([self.prefixes[k], own])
        return prompt, int(self.sizes.out[j])

    def first_round(self) -> list[tuple[np.ndarray, int]]:
        out = []
        for c in range(self.clients):
            prompt, budget = self._request(c)
            out.append((prompt, max(1, -(-budget * (c + 1) // self.clients))))
        self._i = self.clients
        return out

    def next(self) -> tuple[np.ndarray, int]:
        req = self._request(self._i)
        self._i += 1
        return req

    def due(self, finished: int, elapsed_s: float) -> list[tuple[np.ndarray, int]]:
        """One new request for every one that finished."""
        return [self.next() for _ in range(finished)]


def make(mix: dict, vocab: int, seed: int) -> ClosedLoop:
    return ClosedLoop(mix, vocab, seed)
