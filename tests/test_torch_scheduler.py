"""The port's scheduler: priorities, preemption with replay, and deadlines.

Against the reference (``smollm-360m-smoke`` in float32, the reference's
weights moved through the bridge): one scripted workload of priorities and
deadlines, submitted at the same steps to both packages' engines, must end
with equal statuses, preemption counts, ``ttft_steps`` and greedy tokens, in
both KV layouts and on a block-starved pool.  Within the port: a preempted
request's output is bitwise its uninterrupted output at temperature 0.8
(and, for every family, its slot's cache state when it finishes), equal
priorities never preempt, and ``priorities=False`` is FIFO.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import kvcache
from repro_torch.serve import engine as te

MAX_LEN, BS = 64, 16

# (submit step, prompt length, budget, priority, deadline_steps): three
# low-priority requests fill two slots, urgent arrivals preempt them, and
# deadlines expire one request while queued and one while active
SCRIPT = [
    (0, 10, 12, 0, None), (0, 20, 10, 0, None), (0, 7, 8, 0, 15),
    (3, 9, 5, 3, None), (3, 12, 6, 1, 4), (6, 30, 4, 3, None),
    (7, 5, 9, 0, 6), (9, 14, 7, 2, None),
]


@pytest.fixture(scope="module")
def smol():
    jax = pytest.importorskip("jax")
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro_torch import bridge

    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg_j, jparams, cfg_t, tparams


@pytest.fixture(scope="module")
def own():
    """The port's own fp32 smoke model (within-port tests)."""
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _scfg(mod, layout, batch=2, num_blocks=None, **kw):
    kv = (mod.KVConfig(layout="paged", block_size=BS, num_blocks=num_blocks)
          if layout == "paged" else mod.KVConfig(decode_block=BS))
    return mod.ServeConfig(
        max_len=MAX_LEN, scheduler=mod.SchedulerConfig(batch=batch, prefill_bucket=16),
        kv=kv, **kw,
    )


def _drive(mod, eng, vocab, script=SCRIPT, seed=3):
    """Submit ``script`` at its steps, drive dry, return each request's
    result (status, preemptions, ttft, tokens) and the engine's counters."""
    rng = np.random.default_rng(seed)
    reqs = [(at, mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=m,
                             request_id=i, priority=p, deadline_steps=d))
            for i, (at, n, m, p, d) in enumerate(script)]
    step = 0
    while True:
        for at, r in reqs:
            if at == step:
                eng.submit(r)
        alive = eng.step()
        step += 1
        if not alive and all(at < step for at, _ in reqs):
            break
    out = []
    for _, r in reqs:
        res = eng.pop_result(r.request_id)
        out.append((res.status.value, res.preemptions, res.ttft_steps, res.tolist()))
    stats = {k: eng.stats[k] for k in ("preempted", "recovered", "expired", "admitted")}
    return out, stats


@pytest.mark.parametrize("layout,num_blocks", [
    ("contiguous", None), ("paged", None), ("paged", 6),
])
def test_priorities_and_deadlines_equal_reference(smol, layout, num_blocks):
    from repro.serve import engine as je

    cfg_j, jparams, cfg_t, tparams = smol
    want, jstats = _drive(je, je.Engine(cfg_j, jparams, _scfg(je, layout, num_blocks=num_blocks)),
                          cfg_j.vocab)
    got, tstats = _drive(te, te.Engine(cfg_t, tparams, _scfg(te, layout, num_blocks=num_blocks),
                                       device="cpu"), cfg_t.vocab)
    assert got == want
    assert tstats == jstats
    assert tstats["preempted"] > 0 and tstats["expired"] > 0
    statuses = {s for s, *_ in got}
    assert {"FINISHED", "FAILED"} <= statuses


def _slot_state(eng, slot):
    return kvcache._tree_map(torch.clone, kvcache.take_slot(eng.caches, slot, eng._axes))


def _replay_run(cfg, params, prompts, budget, preempt_at=None, layout="contiguous"):
    """Two requests admitted together (equal prompt lengths, so every family
    prefills them as one group); with ``preempt_at`` request 0 is preempted
    after that many steps and re-prefills alone.  Returns request 0's
    tokens, its preemption count, every callback index it emitted, and
    (contiguous) its slot's cache state when it finished."""
    scfg = te.ServeConfig(
        max_len=MAX_LEN, temperature=0.8, seed=13,
        scheduler=te.SchedulerConfig(batch=2),
        kv=te.KVConfig(layout=layout, block_size=BS) if layout == "paged"
        else te.KVConfig(decode_block=BS),
    )
    eng = te.Engine(cfg, params, scfg, device="cpu")
    seen: dict = {"idx": []}

    def on_token(rid, tok, idx, done):
        if rid != 0:
            return
        seen["idx"].append(idx)
        if done and layout == "contiguous":
            seen["state"] = _slot_state(eng, eng._slot_of(0))

    for i, p in enumerate(prompts):
        eng.submit(te.Request(p, max_new=budget, request_id=i))
    steps = 0
    while eng.step(on_token):
        steps += 1
        if steps == preempt_at:
            assert eng.preempt(0) and eng.status(0) == te.RequestStatus.PREEMPTED
    res = eng.pop_result(0)
    assert res.status == te.RequestStatus.FINISHED
    return res.tolist(), res.preemptions, seen, eng.stats


def _family(arch):
    cfg = dataclasses.replace(treg.get(arch), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(1), "cpu")


@pytest.mark.parametrize("arch,layout", [
    ("smollm-360m-smoke", "contiguous"), ("smollm-360m-smoke", "paged"),
    ("rwkv6-1.6b-smoke", "contiguous"), ("recurrentgemma-2b-smoke", "contiguous"),
])
def test_preempted_equals_uninterrupted_bitwise(arch, layout):
    """Temperature 0.8: the victim re-prefills alone (it was admitted in a
    group of two), re-derives its first token and replays 5 more; its
    output, its callback indices (each emitted once, in order) and its
    slot's final cache state are bitwise the uninterrupted run's.  The recurrent families run their
    plain WKV-6 and linear-scan versions."""
    cfg, params = _family(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, 11).astype(np.int32) for _ in range(2)]
    want, _, base, _ = _replay_run(cfg, params, prompts, 14, layout=layout)
    got, n_pre, seen, stats = _replay_run(cfg, params, prompts, 14, preempt_at=5, layout=layout)
    assert got == want and n_pre == 1
    assert stats["preempted"] == stats["recovered"] == 1 and stats["replayed"] == 5
    assert seen["idx"] == list(range(14))
    if layout == "contiguous":
        flat_a, flat_b = [], []
        kvcache._tree_map(lambda a, b: flat_a.append(a) or flat_b.append(b),
                          base["state"], seen["state"])
        assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))


def test_priority_preemption_order_and_events(own):
    """After the reference's test: a starved higher-priority arrival
    preempts the only active request, finishes first, and the victim
    resumes without re-emitting a token."""
    cfg, params = own
    scfg = te.ServeConfig(max_len=48, temperature=0.6, seed=13,
                          scheduler=te.SchedulerConfig(batch=1))
    eng = te.Engine(cfg, params, scfg, device="cpu")
    rng = np.random.default_rng(41)
    pl, ph = (rng.integers(0, cfg.vocab, 8).astype(np.int32) for _ in range(2))
    events = []
    cb = lambda rid, tok, idx, done: events.append((rid, idx, done))  # noqa: E731
    eng.submit(te.Request(pl, 12, request_id=0))
    eng.step(cb)
    eng.step(cb)
    eng.submit(te.Request(ph, 4, request_id=1, priority=5))
    while eng.step(cb):
        pass
    rl, rh = eng.pop_result(0), eng.pop_result(1)
    assert (rl.preemptions, rh.preemptions) == (1, 0)
    assert [rid for rid, _, done in events if done] == [1, 0]
    assert [idx for rid, idx, _ in events if rid == 0] == list(range(12))
    solo = te.Engine(cfg, params, scfg, device="cpu").run([te.Request(pl, 12, request_id=0)])[0]
    assert rl.tolist() == solo.tolist()


def test_equal_priority_never_preempts(own):
    cfg, params = own
    eng = te.Engine(cfg, params, te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=1)),
                    device="cpu")
    rng = np.random.default_rng(43)
    eng.submit(te.Request(rng.integers(0, cfg.vocab, 5).astype(np.int32), 6, priority=2))
    eng.step()
    eng.submit(te.Request(rng.integers(0, cfg.vocab, 5).astype(np.int32), 4, priority=2))
    while eng.step():
        pass
    assert eng.stats["preempted"] == 0
    assert eng.pop_result(0).status == te.RequestStatus.FINISHED


@pytest.mark.parametrize("priorities", [True, False])
def test_priorities_false_is_fifo(own, priorities):
    """With priorities, a later urgent request jumps the queue and preempts;
    with ``priorities=False`` admission is pure arrival order and nothing
    is preempted."""
    cfg, params = own
    eng = te.Engine(cfg, params, te.ServeConfig(
        max_len=32, scheduler=te.SchedulerConfig(batch=1, priorities=priorities)), device="cpu")
    rng = np.random.default_rng(5)
    order = []
    cb = lambda rid, tok, idx, done: idx == 0 and order.append(rid)  # noqa: E731
    for rid, prio in ((0, 0), (1, 0), (2, 5)):
        eng.submit(te.Request(rng.integers(0, cfg.vocab, 4).astype(np.int32), 3,
                              request_id=rid, priority=prio))
    while eng.step(cb):
        pass
    if priorities:
        assert order == [2, 0, 1] and eng.stats["preempted"] == 0  # queued, not active
    else:
        assert order == [0, 1, 2] and eng.stats["preempted"] == 0
    # an urgent arrival against an ACTIVE request: preempts only with priorities
    eng2 = te.Engine(cfg, params, te.ServeConfig(
        max_len=32, scheduler=te.SchedulerConfig(batch=1, priorities=priorities)), device="cpu")
    eng2.submit(te.Request(np.arange(4), 6, request_id=0))
    eng2.step()
    eng2.submit(te.Request(np.arange(5), 2, request_id=1, priority=9))
    while eng2.step():
        pass
    assert eng2.stats["preempted"] == (1 if priorities else 0)


def test_deadlines_expire_waiting_and_active(own):
    """Expiry in the queue FAILs with no tokens; expiry while active evicts
    with the generated prefix intact (the uninterrupted run's prefix)."""
    cfg, params = own
    scfg = te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=1))
    rng = np.random.default_rng(19)
    pa, pb = (rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(2))
    eng = te.Engine(cfg, params, scfg, device="cpu")
    eng.submit(te.Request(pa, 10, request_id=0))
    eng.submit(te.Request(pb, 10, request_id=1, deadline_steps=3))
    while eng.step():
        pass
    rb = eng.pop_result(1)
    assert rb.status == te.RequestStatus.FAILED and "queue" in rb.reason and len(rb) == 0
    eng2 = te.Engine(cfg, params, scfg, device="cpu")
    eng2.submit(te.Request(pa, 10, request_id=0, deadline_steps=4))
    while eng2.step():
        pass
    ra = eng2.pop_result(0)
    assert ra.status == te.RequestStatus.FAILED and "active" in ra.reason
    solo = te.Engine(cfg, params, scfg, device="cpu").run([te.Request(pa, 10, request_id=0)])[0]
    assert 1 <= len(ra) < 10 and ra.tolist() == solo.tolist()[: len(ra)]
    assert eng2.stats["expired"] == 1
    with pytest.raises(ValueError, match="deadline"):
        eng2.submit(te.Request(pa, 4, request_id=9, deadline_steps=-1))


def test_replay_divergence_raises_before_emission(own, monkeypatch):
    """A replayed token that differs from the record raises
    ``ReplayDivergedError`` naming the request, the index and both tokens,
    and nothing of that step is emitted."""
    cfg, params = own
    eng = te.Engine(cfg, params, te.ServeConfig(max_len=32, scheduler=te.SchedulerConfig(batch=1)),
                    device="cpu")
    eng.submit(te.Request(np.arange(6), 8, request_id=0))
    for _ in range(4):
        eng.step()
    assert eng.preempt(0)
    eng._outputs[0][2] = (eng._outputs[0][2] + 1) % cfg.vocab  # tamper with the record
    emitted = []
    with pytest.raises(te.ReplayDivergedError, match="request 0: recovery replay diverged at "
                                                     "token 2") as e:
        while eng.step(lambda *a: emitted.append(a)):
            pass
    assert (e.value.rid, e.value.index) == (0, 2) and not emitted


def test_request_result_field_order():
    """``preemptions`` sits before ``ttft_steps``, as in the reference, so a
    positional construction means the same in both packages."""
    names = [f.name for f in dataclasses.fields(te.RequestResult)]
    assert names == ["status", "tokens", "reason", "preemptions", "ttft_steps"]
    r = te.RequestResult(te.RequestStatus.FINISHED, np.zeros(2, np.int32), "", 2, 7)
    assert (r.preemptions, r.ttft_steps) == (2, 7)
    assert [s.value for s in te.RequestStatus][:4] == ["WAITING", "PREFILLING", "ACTIVE",
                                                       "PREEMPTED"]
