"""The port's ``StaticEngine``, the static-batch baseline.

Against the reference (``smollm-360m-smoke`` in float32, the reference's
weights moved through the bridge): greedy tokens equal the reference
``StaticEngine``'s, left-padded batches included.  Within the port: on
equal-length prompts its tokens equal ``Engine``'s (greedy, and at
temperature 0.8, since both sample per (seed, request id, token index)),
its stream reports every token once, and the paged layout is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import engine as te


def _reqs(mod, vocab, spec, seed=2):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate(spec)]


def _scfg(mod, **kw):
    return mod.ServeConfig(max_len=48, scheduler=mod.SchedulerConfig(batch=2), **kw)


@pytest.fixture(scope="module")
def own():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("spec", [
    [(6, 5), (6, 7), (6, 4), (6, 6)],          # equal prompts, two batches
    [(3, 5), (11, 7), (8, 4)],                  # left-padded, a short last batch
])
def test_greedy_tokens_equal_reference_static_engine(spec):
    jax = pytest.importorskip("jax")
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro.serve import engine as je
    from repro_torch import bridge

    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = je.StaticEngine(cfg_j, jparams, _scfg(je)).generate(_reqs(je, cfg_j.vocab, spec))
    got = te.StaticEngine(cfg_t, tparams, _scfg(te), device="cpu").generate(
        _reqs(te, cfg_t.vocab, spec))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_equal_prompts_equal_engine_tokens(own, temperature):
    """No prompt is padded, so every row's arithmetic is the continuous
    engine's: the tokens are the same bits (the reference's contract is
    greedy; the port's sampler makes it hold at temperature too)."""
    cfg, params = own
    spec = [(6, 5), (6, 7), (6, 4), (6, 6)]
    kw = dict(temperature=temperature, seed=3)
    cont = te.Engine(cfg, params, _scfg(te, **kw), device="cpu").run(_reqs(te, cfg.vocab, spec))
    stat = te.StaticEngine(cfg, params, _scfg(te, **kw), device="cpu").generate(
        _reqs(te, cfg.vocab, spec))
    assert [s.tolist() for s in stat] == [c.tolist() for c in cont]


def test_stream_reports_each_token_once(own):
    cfg, params = own
    spec = [(5, 3), (7, 5), (4, 2)]
    events = []
    outs = te.StaticEngine(cfg, params, _scfg(te), device="cpu").generate(
        _reqs(te, cfg.vocab, spec), on_token=lambda *a: events.append(a))
    for i, (_, m) in enumerate(spec):
        mine = [(idx, tok, done) for rid, tok, idx, done in events if rid == i]
        assert [e[0] for e in mine] == list(range(m))
        assert [e[1] for e in mine] == outs[i].tolist()
        assert [e[2] for e in mine] == [False] * (m - 1) + [True]


def test_paged_layout_is_refused(own):
    cfg, params = own
    scfg = te.ServeConfig(max_len=48, kv=te.KVConfig(layout="paged", block_size=16))
    with pytest.raises(ValueError, match="contiguous layout only"):
        te.StaticEngine(cfg, params, scfg, device="cpu")
