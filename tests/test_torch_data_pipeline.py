"""Port parity: the synthetic token pipeline (``repro_torch.data.pipeline``,
the port's own copy of ``repro/data/pipeline.py``) gives the reference's
batches bit for bit, by ``batch_at`` and through the prefetching
``Pipeline``, on one host and on several."""

import time

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=16, global_batch=4),
    dict(vocab=49152, seq_len=64, global_batch=8, seed=7, structure=0.0),
    dict(vocab=1000, seq_len=8, global_batch=8, num_hosts=4, host_id=2, structure=0.5),
])
def test_batch_at_equals_reference(kw):
    jc, tc = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    for step in (0, 1, 17, 10_000):
        want, got = jpipe.batch_at(jc, step), tpipe.batch_at(tc, step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    b = tpipe.batch_at(tc, 3)
    assert b["tokens"].shape == (kw["global_batch"] // kw.get("num_hosts", 1), kw["seq_len"])
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_streams_the_reference_batches_from_its_start_step():
    cfg = tpipe.DataConfig(vocab=300, seq_len=12, global_batch=2, seed=3)
    pipe = tpipe.Pipeline(cfg, start_step=5, prefetch=2)
    try:
        for want_step in range(5, 11):
            step, batch = next(pipe)
            assert step == want_step
            ref = jpipe.batch_at(jpipe.DataConfig(vocab=300, seq_len=12, global_batch=2, seed=3),
                                 step)
            for k in ref:
                assert np.array_equal(batch[k], ref[k])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_delay_slows_the_producer():
    cfg = tpipe.DataConfig(vocab=64, seq_len=4, global_batch=1)
    pipe = tpipe.Pipeline(cfg, delay_s=0.05, prefetch=1)
    try:
        t0 = time.perf_counter()
        for _ in range(4):
            next(pipe)
        assert time.perf_counter() - t0 >= 0.15
    finally:
        pipe.close()
