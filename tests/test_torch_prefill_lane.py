"""The port's chunked-prefill lane and its fixed-shape prefill.

Within the port (``smollm-360m-smoke`` in float32, the port's own weights,
on the CPU): the lane under the reference's (chunk, budget) grid gives
bitwise the tokens of monolithic admission at temperature 0.8 in both KV
layouts; PREFILLING is observable with the right ``ttft_steps``; a prefill
in flight can be preempted (bitwise recovery), cancelled and expired
without leaking; the config errors are the reference's.  The fixed-shape
prefill (``Dispatch.q_block``) gives a prompt's K, V and first-token logits
the same bits alone, in a group and in chunks, and stays within the float32
tolerance of the reference's prefill (1e-5 of the logit scale).  Against
the reference: greedy lane tokens equal its lane's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.arch import layers as L
from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import kvcache
from repro_torch.serve import engine as te

MAX_LEN = 64
SPEC = [(5, 6), (37, 9), (3, 4), (23, 5), (58, 4), (12, 7)]  # (prompt, budget)


@pytest.fixture(scope="module")
def own():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _reqs(mod, vocab, spec=SPEC, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate(spec)]


def _scfg(mod, layout, chunk=0, budget=None, batch=3, **kw):
    kv = mod.KVConfig(layout="paged", block_size=16) if layout == "paged" else mod.KVConfig()
    return mod.ServeConfig(
        max_len=MAX_LEN, kv=kv, **kw,
        scheduler=mod.SchedulerConfig(batch=batch, prefill_chunk=chunk, token_budget=budget),
    )


@pytest.mark.parametrize("chunk,budget", [(8, 8), (16, 32), (64, None)])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lane_bitwise_equals_monolithic(own, layout, chunk, budget):
    """The reference's invariant: the lane under any (chunk, budget) is
    scheduling only.  chunk 8 at budget 8 is one chunk a step; chunk 64
    with no budget admits whole prompts within one step."""
    cfg, params = own
    kw = dict(temperature=0.8, seed=11)
    mono = te.Engine(cfg, params, _scfg(te, layout, **kw), device="cpu").run(_reqs(te, cfg.vocab))
    eng = te.Engine(cfg, params, _scfg(te, layout, chunk, budget, **kw), device="cpu")
    outs = eng.run(_reqs(te, cfg.vocab))
    for i, (m, c) in enumerate(zip(mono, outs)):
        assert m.status == c.status == te.RequestStatus.FINISHED
        assert c.tolist() == m.tolist(), f"rid {i}: {c.tolist()} != monolithic {m.tolist()}"
    if layout == "paged":
        eng.pool.assert_invariants(eng.live_block_refs())
        assert eng.pool.free_blocks == eng.pool.num_blocks - 1


def test_prefilling_status_observable_and_ttft(own):
    """A budget-bound 40-token prompt is PREFILLING (a live, non-consuming
    snapshot with no tokens) for the 4 steps between its 5 chunks, and
    ``ttft_steps`` counts the steps from submit to its first token."""
    cfg, params = own
    eng = te.Engine(cfg, params, _scfg(te, "contiguous", 8, 8, batch=2), device="cpu")
    rng = np.random.default_rng(23)
    rid = eng.submit(te.Request(rng.integers(0, cfg.vocab, 40).astype(np.int32), 4))
    seen = 0
    while eng.status(rid) in (te.RequestStatus.WAITING, te.RequestStatus.PREFILLING):
        assert len(eng.pop_result(rid)) == 0
        eng.step()
        if eng.status(rid) == te.RequestStatus.PREFILLING:
            seen += 1
            assert eng._lane is not None and eng._lane.filled == 8 * seen
    assert seen == 4
    while eng.step():
        pass
    res = eng.pop_result(rid)
    assert res.status == te.RequestStatus.FINISHED and res.ttft_steps == 5 and len(res) == 4


def test_preempt_mid_prefill_recovers_bitwise(own):
    """An urgent arrival takes the lane between chunks: the bulk victim
    drops its half-built scratch (blocks released, nothing emitted),
    requeues PREEMPTED, re-prefills later and finishes bitwise as an
    undisturbed run; so does the urgent request."""
    cfg, params = own
    scfg = _scfg(te, "paged", 8, 8, batch=1, temperature=0.7, seed=13)
    eng = te.Engine(cfg, params, scfg, device="cpu")
    rng = np.random.default_rng(29)
    bulk, inter = (rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (40, 6))
    eng.submit(te.Request(bulk, 5, request_id=0))
    eng.step()
    assert eng.status(0) == te.RequestStatus.PREFILLING
    eng.submit(te.Request(inter, 3, request_id=1, priority=5))
    eng.step()
    assert eng.status(0) == te.RequestStatus.PREEMPTED
    assert eng.status(1) in (te.RequestStatus.PREFILLING, te.RequestStatus.ACTIVE)
    while eng.step():
        pass
    r0, r1 = eng.pop_result(0), eng.pop_result(1)
    assert (r0.status, r0.preemptions, r1.preemptions) == (te.RequestStatus.FINISHED, 1, 0)
    for prompt, budget, rid, res in ((bulk, 5, 0, r0), (inter, 3, 1, r1)):
        solo = te.Engine(cfg, params, scfg, device="cpu").run(
            [te.Request(prompt, budget, request_id=rid)])[0]
        assert res.tolist() == solo.tolist()
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1, "leaked blocks"


def test_cancel_and_deadline_mid_prefill(own):
    """cancel() and a deadline both reach a PREFILLING request: the lane
    drops with no tokens, its blocks return to the pool and the slot
    backfills."""
    cfg, params = own
    eng = te.Engine(cfg, params, _scfg(te, "paged", 8, 8, batch=1), device="cpu")
    long_p = np.random.default_rng(31).integers(0, cfg.vocab, 40).astype(np.int32)
    eng.submit(te.Request(long_p, 4, request_id=0))
    eng.step()
    assert eng.status(0) == te.RequestStatus.PREFILLING
    assert eng.cancel(0) == te.RequestStatus.CANCELLED
    assert len(eng.pop_result(0)) == 0 and eng._lane is None
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1
    eng.submit(te.Request(long_p, 4, request_id=1, deadline_steps=2))
    while eng.step():
        pass
    res = eng.pop_result(1)
    assert res.status == te.RequestStatus.FAILED and "prefilling" in res.reason
    assert eng.stats["expired"] == 1 and eng.pool.free_blocks == eng.pool.num_blocks - 1


def test_config_errors_as_the_reference():
    with pytest.raises(ValueError, match="prefill_chunk"):
        te.SchedulerConfig(prefill_chunk=-1)
    with pytest.raises(ValueError, match="token_budget"):
        te.SchedulerConfig(token_budget=64)  # only meaningful with chunked prefill
    with pytest.raises(ValueError, match="token_budget"):
        te.SchedulerConfig(prefill_chunk=16, token_budget=8)  # budget < one chunk
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        te.ServeConfig(max_len=100, scheduler=te.SchedulerConfig(prefill_chunk=16))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b-smoke", "recurrentgemma-2b-smoke"])
def test_lane_refuses_recurrent_and_ring_families(arch):
    cfg = treg.get(arch)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prefill_chunk needs all-global attention"):
        te.Engine(cfg, params, _scfg(te, "contiguous", 8), device="cpu")


def _row_prefill(model, params, prompts, lpad, dispatch):
    toks = np.zeros((len(prompts), lpad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    caches = kvcache.build_caches(model.cfg, len(prompts), MAX_LEN, "cpu")
    tl = torch.tensor([len(p) - 1 for p in prompts])
    logits, _ = model.prefill(params, torch.from_numpy(toks), caches, last_index=tl,
                              dispatch=dispatch)
    return logits, caches


def test_fixed_shape_prefill_rows_bitwise(own):
    """With ``q_block`` a prompt's K, V (every layer, its positions) and
    first-token logits are the same bits in a group of four (bucket 48),
    alone (bucket 32) and through 8-token chunks from the cache cursor."""
    cfg, params = own
    model = build(cfg)
    d = L.Dispatch(q_block=te.PREFILL_Q_BLOCK)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (41, 29, 17, 9)]
    g_logits, g_c = _row_prefill(model, params, prompts, 48, d)
    a_logits, a_c = _row_prefill(model, params, prompts[1:2], 32, d)
    lane = kvcache.build_caches(cfg, 1, MAX_LEN, "cpu")
    p = prompts[1]
    for lo in range(0, len(p), 8):
        part = np.zeros((1, 8), np.int32)
        part[0, : len(p[lo : lo + 8])] = p[lo : lo + 8]
        c_logits, _ = model.prefill(params, torch.from_numpy(part), lane,
                                    last_index=torch.tensor([len(p[lo : lo + 8]) - 1]),
                                    dispatch=d, from_cursor=True)
    n = len(p)
    for other, logits in ((a_c, a_logits), (lane, c_logits)):
        assert torch.equal(g_c["k"][:, 1, :n], other["k"][:, 0, :n])
        assert torch.equal(g_c["v"][:, 1, :n], other["v"][:, 0, :n])
        assert torch.equal(g_logits[1], logits[0])


def test_fixed_shape_prefill_matches_reference():
    """The pieces keep the dense path's arithmetic: the port's prefill with
    ``q_block`` (pieces of 8 queries, two calls a layer) stays within 1e-5
    of the logit scale of the reference's prefill, as the plain one does."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro.serve import kvcache as jkv
    from repro_torch import bridge

    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 40)).astype(np.int32)
    last = np.asarray([39, 4, 22], np.int32)
    jl, jc = jbuild(cfg_j).prefill(jparams, jnp.asarray(toks), jkv.build_caches(cfg_j, 3, MAX_LEN),
                                   last_index=jnp.asarray(last))
    tl, tc = build(cfg_t).prefill(tparams, torch.from_numpy(toks),
                                  kvcache.build_caches(cfg_t, 3, MAX_LEN, "cpu"),
                                  last_index=torch.from_numpy(last), dispatch=L.Dispatch(q_block=8))
    scale = max(float(np.abs(np.asarray(jl)).max()), 1.0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lane_greedy_tokens_equal_reference(layout):
    """Both packages' lanes at chunk 8, budget 16 on the reference's fp32
    weights: equal statuses, ``ttft_steps`` and greedy tokens."""
    jax = pytest.importorskip("jax")
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro.serve import engine as je
    from repro_torch import bridge

    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = je.Engine(cfg_j, jparams, _scfg(je, layout, 8, 16)).run(_reqs(je, cfg_j.vocab))
    got = te.Engine(cfg_t, tparams, _scfg(te, layout, 8, 16), device="cpu").run(
        _reqs(te, cfg_t.vocab))
    assert [(o.status.value, o.ttft_steps, o.tolist()) for o in got] == [
        (o.status.value, o.ttft_steps, o.tolist()) for o in want]
