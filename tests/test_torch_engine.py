"""Port parity: the continuous-batching engine against the reference's.

The same weights (the reference's ``Model.init``, moved through the
bridge) and the same requests go through the reference ``Engine`` and the
port's, on ``smollm-360m-smoke`` in float32.  Greedy tokens must be EQUAL
for both KV layouts; the paged workload shares prefixes (full blocks and an
identical prompt tail, so copy-on-write runs).  The two ``BlockPool``s
must agree operation by operation.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch.serve import make_workload as jmake_workload  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch.serve import make_workload  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402

BS, MAX_LEN, SLOTS = 16, 64, 3


@pytest.fixture(scope="module")
def smol():
    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg_j, jparams, cfg_t, tparams


def _shared_prefix_prompts(vocab, seed=1):
    """Two full blocks of shared prefix, extended differently; two
    requests repeat one prompt exactly (shared tail -> copy-on-write)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, 2 * BS + 5).astype(np.int32)
    tails = [rng.integers(0, vocab, n).astype(np.int32) for n in (0, 3, 0, 7)]
    prompts = [np.concatenate([pre, t]) for t in tails]
    prompts.append(rng.integers(0, vocab, 9).astype(np.int32))
    return prompts, [6, 5, 8, 4, 7]


def _requests(mod, prompts, budgets, **kw):
    return [
        mod.Request(p, max_new=b, request_id=i, **kw)
        for i, (p, b) in enumerate(zip(prompts, budgets))
    ]


def _scfgs(mod, layout, **kw):
    if layout == "paged":
        kv = mod.KVConfig(layout="paged", block_size=BS)
    else:
        kv = mod.KVConfig(decode_block=BS)
    return mod.ServeConfig(
        max_len=MAX_LEN,
        scheduler=mod.SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=kv, **kw,
    )


def _tokens(outs):
    return [o.tolist() for o in outs]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_greedy_tokens_equal_reference(smol, layout):
    cfg_j, jparams, cfg_t, tparams = smol
    work = [(r.prompt, r.max_new) for r in jmake_workload(cfg_j, 5, 8, seed=0)]
    prompts, budgets = _shared_prefix_prompts(cfg_j.vocab)
    prompts += [p for p, _ in work]
    budgets += [b for _, b in work]
    want = je.Engine(cfg_j, jparams, _scfgs(je, layout)).run(
        _requests(je, prompts, budgets)
    )
    eng = te.Engine(cfg_t, tparams, _scfgs(te, layout), device="cpu")
    got = eng.run(_requests(te, prompts, budgets))
    assert [o.status.value for o in got] == ["FINISHED"] * len(prompts)
    assert _tokens(got) == _tokens(want)


def test_make_workload_matches_reference(smol):
    cfg_j, _, cfg_t, _ = smol
    for a, b in zip(jmake_workload(cfg_j, 6, 12, seed=3), make_workload(cfg_t, 6, 12, seed=3)):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
        assert a.request_id == b.request_id


def test_block_pool_matches_reference():
    """The same seeded sequence of pool operations on both packages'
    BlockPool leaves the same refcounts, free list and prefix index."""
    from repro.serve.kvcache import BlockPool as JPool

    rng = np.random.default_rng(0)
    pools = [JPool(12, 4), te.kvcache.BlockPool(12, 4)]
    owned: list[int] = []
    held: list[int] = []
    for _ in range(200):
        op = rng.integers(5)
        if op == 0 and pools[0].free_blocks:
            bids = [p.alloc() for p in pools]
            assert bids[0] == bids[1]
            owned.append(bids[0])
        elif op == 1 and owned:
            b = owned[int(rng.integers(len(owned)))]
            for p in pools:
                p.retain(b)
            owned.append(b)
        elif op == 2 and owned:
            b = owned.pop(int(rng.integers(len(owned))))
            for p in pools:
                p.release(b)
        elif op == 3 and owned:
            b, prev = owned[-1], int(rng.integers(-1, 12))
            toks = tuple(int(t) for t in rng.integers(0, 3, 4))
            for p in pools:
                p.register(prev, toks, b)
        elif op == 4:
            if held and rng.random() < 0.5:
                for p in pools:
                    p.unreserve(held)
                held = []
            else:
                n = int(rng.integers(1, 3))
                got = [p.reserve(n) for p in pools]
                assert got[0] == got[1]
                held += got[0]
        toks = [int(t) for t in rng.integers(0, 3, 9)]
        assert pools[0].match_prefix(toks) == pools[1].match_prefix(toks)
        for attr in ("refcount", "free", "index", "external"):
            assert getattr(pools[0], attr) == getattr(pools[1], attr), attr
    refs = {b: owned.count(b) for b in set(owned)}
    for p in pools:
        p.assert_invariants(refs)
