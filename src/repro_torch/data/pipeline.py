"""Deterministic, shardable synthetic token pipeline; a copy of
``repro/data/pipeline.py`` (numpy only), kept here so that the port
imports nothing of the reference.  The same (seed, step, host) gives the
same batch in both packages, bit for bit.

Production shape without production data: every batch is derived from
(seed, step, host) counters, so

  * restarts resume mid-epoch exactly (checkpoint stores the step),
  * each data-parallel host generates only its shard (no central loader),
  * prefetch runs on a background thread with a bounded queue,
  * a configurable per-host delay injector simulates stragglers for the
    fault-tolerance tests (train/loop.py's straggler monitor).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    # markov-ish structure so loss can actually decrease in examples
    structure: float = 0.8


def _host_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    per_host = cfg.global_batch // cfg.num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    b = per_host
    toks = rng.integers(0, cfg.vocab, (b, cfg.seq_len + 1), dtype=np.int32)
    # inject learnable structure: with prob `structure`, next token is a
    # deterministic function of the previous one
    if cfg.structure > 0:
        nxt = (toks[:, :-1] * 31 + 7) % cfg.vocab
        mask = rng.random((b, cfg.seq_len)) < cfg.structure
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Pipeline:
    """Background-prefetching iterator over deterministic steps."""

    def __init__(
        self,
        cfg: DataConfig,
        start_step: int = 0,
        prefetch: int = 2,
        delay_s: float = 0.0,
    ):
        self.cfg = cfg
        self._step = start_step
        self._delay = delay_s
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            if self._delay:
                time.sleep(self._delay)
            batch = _host_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Pure function view (used by tests + elastic resume validation)."""
    return _host_batch(cfg, step)
