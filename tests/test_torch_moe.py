"""Port parity: the MoE FFN (``repro_torch.arch.moe``) and the MoE models
(granite-moe-1b-a400m, grok-1-314b) on the CPU, against the reference.

The same weights (the reference's init, moved through the bridge) and the
same seeded numpy inputs go through both packages.  At init the router's
logits are so small that routing is close to uniform and the layers
barely move the residual stream, so the fixtures scale every matrix but
the embedding by a gain, the same bits in both packages.

Tolerances: fp32 to 1e-5 of the output's scale (XLA and PyTorch sum in
other orders); bf16 to 2e-2 of it.  Greedy tokens must be equal.

Tight capacity (``capacity_factor`` 0.5) exercises the reference's
dispatch scatter, which writes one slot twice when an expert overflows:
the kept rank-``C - 1`` token and then a dropped token's zeros land in
the same slot, and on the CPU the zeros win.  The port computes that
result explicitly (``moe._filled``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import moe as jmoe  # noqa: E402
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch import moe as tmoe  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


def _scaled(tree, gain):
    """Every matrix but the token embedding times ``gain`` (norm scales
    and the embedding stay), in the leaf's dtype."""
    def f(path, a):
        key = str(path[-1])
        if a.ndim >= 2 and "scale" not in key and "tok" not in key:
            return (a * gain).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _pair(tree):
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, device="cpu")


# ---------------------------------------------------------------- the FFN --


def _moe_cfgs(E=4, K=2, cf=8.0, act="swiglu", dtype="float32"):
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=64, head_dim=8, mlp_act=act, dtype=dtype)
    return (jbase.ModelConfig(moe=jbase.MoEConfig(E, K, 16, cf), **kw),
            tbase.ModelConfig(moe=tbase.MoEConfig(E, K, 16, cf), **kw))


def _moe_inputs(cfg_j, shape=(3, 16, 32), gain=30.0, seed=1):
    tree = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j))
    tree = {k: (v * gain).astype(v.dtype) for k, v in tree.items()}
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return tree, x


_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=1)


def _both(cfg_j, cfg_t, tree, x, dtype):
    jp, tp = _pair(tree)
    oj, aj = _jmoe_apply(jp, cfg_j, jnp.asarray(x).astype(dtype))
    ot, at = tmoe.moe_apply(tp, cfg_t, torch.from_numpy(x).to(getattr(torch, dtype)))
    return (oj, aj), (ot, at)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (4, 4)])
def test_moe_apply_matches_reference(E, K, act):
    """The grid of the reference's ``tests/test_moe.py``, in fp32 and at its
    default capacity factor, with the aux loss."""
    cfg_j, cfg_t = _moe_cfgs(E, K, 1.25, act)
    tree, x = _moe_inputs(cfg_j)
    (oj, aj), (ot, at) = _both(cfg_j, cfg_t, tree, x, "float32")
    _close(ot, oj, "float32")
    assert at.dtype == torch.float32 and abs(float(at) - float(aj)) < 1e-5 * float(aj)
    assert float(at) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (4, 4)])
def test_tight_capacity_zeroes_the_overflowing_experts_last_slot(E, K, dtype, monkeypatch):
    """At ``cf`` 0.5 experts overflow.  The port matches the reference, and
    the duplicate-slot rule is what makes it match: the same computation
    with the overflowing experts' slot ``C - 1`` kept (the other reading
    of the colliding writes) does not."""
    cfg_j, cfg_t = _moe_cfgs(E, K, 0.5, "swiglu", dtype)
    tree, x = _moe_inputs(cfg_j)
    (oj, _), (ot, _) = _both(cfg_j, cfg_t, tree, x, dtype)
    _close(ot, oj, dtype)
    tp = bridge.params_from_jax(tree)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    _, _, ids = tmoe.route(tp, cfg_t, xt)
    B, S, _ = xt.shape
    counts = torch.nn.functional.one_hot(ids.reshape(B, S * K), E).sum(1)
    C = tmoe.capacity(cfg_t, S)
    assert (counts > C).any(), "no expert overflows: the test checks nothing"
    monkeypatch.setattr(
        tmoe, "_filled", lambda n, c: torch.arange(c) < torch.clamp(n, max=c)[..., None])
    twin, _ = tmoe.moe_apply(tp, cfg_t, xt)
    scale = float(np.abs(_np(oj)).max())
    assert float(np.abs(_np(twin) - _np(oj)).max()) > REL[dtype] * scale


def test_rows_route_independently():
    """A row's output does not depend on the other rows: close in a plain
    call (one batched product), bitwise under ``Dispatch.q_block``, where
    every row runs alone."""
    cfg_j, cfg_t = _moe_cfgs(4, 2, 1.25)
    tree, x = _moe_inputs(cfg_j, shape=(4, 12, 32))
    tp = bridge.params_from_jax(tree)
    xt = torch.from_numpy(x)
    fixed = tL.Dispatch(q_block=8)
    batch, _ = tmoe.moe_apply(tp, cfg_t, xt, fixed)
    plain, _ = tmoe.moe_apply(tp, cfg_t, xt)
    for r in range(4):
        alone, _ = tmoe.moe_apply(tp, cfg_t, xt[r : r + 1])
        assert torch.equal(alone[0], batch[r])
        _close(plain[r], alone[0], "float32")


def test_repeat_call_is_bitwise():
    cfg_j, cfg_t = _moe_cfgs(8, 2, 0.5, "gelu", "bfloat16")
    tree, x = _moe_inputs(cfg_j)
    tp = bridge.params_from_jax(tree)
    xt = torch.from_numpy(x).bfloat16()
    a, aa = tmoe.moe_apply(tp, cfg_t, xt)
    b, ab = tmoe.moe_apply(tp, cfg_t, xt)
    assert torch.equal(a, b) and torch.equal(aa, ab)


def test_capacity_and_top_k_ties_follow_the_reference():
    """C = max(1, ceil(S K cf / E)); tied probabilities go to the lower
    expert id, as ``jax.lax.top_k`` breaks them."""
    _, cfg = _moe_cfgs(32, 8, 1.25)
    assert [tmoe.capacity(cfg, s) for s in (1, 3, 4, 260)] == [1, 1, 2, 82]
    _, cfg = _moe_cfgs(4, 2, 1.25)
    params = {"router": torch.zeros((32, 4))}
    _, gate, ids = tmoe.route(params, cfg, torch.randn(2, 3, 32))
    assert ids.tolist() == [[[0, 1]] * 3] * 2 and torch.all(gate == 0.5)


# ------------------------------------------------------------- the models --

ARCHS = ["granite-moe-1b-a400m-smoke", "grok-1-314b-smoke"]


def _model(arch, dtype, gain):
    cfg_j = dataclasses.replace(jreg.get(arch), dtype=dtype)
    cfg_t = dataclasses.replace(treg.get(arch), dtype=dtype)
    tree = _scaled(jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(0))), gain)
    return cfg_j, cfg_t, *_pair(tree)


@pytest.mark.parametrize("arch,dtype", [(ARCHS[0], "float32"), (ARCHS[0], "bfloat16"),
                                        (ARCHS[1], "bfloat16")])
def test_model_prefill_and_decode_logits(arch, dtype):
    """Three 20-token prompts, then four decode steps (the decode kernel's
    plain version on the last), logits and caches against the reference."""
    cfg_j, cfg_t, jp, tp = _model(arch, dtype, 8.0)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 20)).astype(np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jprefill(jp, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    for i in range(4):
        step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
        jd, jc = jdecode(jp, jnp.asarray(step), jc)
        disp = tL.Dispatch(attention="flash") if i == 3 else tL.PLAIN
        td, tc = tm.decode_step(tp, torch.from_numpy(step), tc, dispatch=disp)
        _close(td, jd, dtype)
    _close(tc["k"], jc["k"], dtype)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_port_init_has_the_reference_tree():
    """Paths, shapes and dtypes of the port's own init; the router fp32
    normal 0.02, the experts normal 0.02/sqrt(d)."""
    cfg_j, cfg_t = jreg.get(ARCHS[0]), treg.get(ARCHS[0])
    want = jax.tree_util.tree_flatten_with_path(jbuild(cfg_j).init(jax.random.PRNGKey(0)))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        tbuild(cfg_t).init(torch.Generator().manual_seed(0), "cpu"))[0])
    assert [p for p, _ in want] == list(got)
    for path, a in want:
        assert tuple(got[path].shape) == a.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == a.dtype.name, path
    own = tbuild(cfg_t).init(torch.Generator().manual_seed(0), "cpu")["layers"]["moe"]
    assert own["router"].dtype == torch.float32 and abs(own["router"].std() - 0.02) < 0.004
    d = cfg_t.d_model
    assert abs(own["w_in"].float().std() - 0.02 / d**0.5) < 0.0003


def _workload(mod, vocab, seed=4):
    """Four prompts sharing a 24-token prefix (three full 8-token blocks),
    two independent ones; four prompt lengths (MoE admission groups by
    exact length)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 24)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(np.int32)
               for n in (3, 7, 3, 7)]
    prompts += [rng.integers(0, vocab, n).astype(np.int32) for n in (9, 9)]
    budgets = [6, 9, 5, 8, 7, 6]
    return [mod.Request(p, max_new=b, request_id=i)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def _scfg(mod, layout, sharing=True):
    return mod.ServeConfig(
        max_len=64, scheduler=mod.SchedulerConfig(batch=3, prefill_bucket=16),
        kv=mod.KVConfig(layout=layout, block_size=8, prefix_sharing=sharing),
        kernel=mod.KernelConfig(attention="flash"))


@pytest.fixture(scope="module")
def granite_runs():
    """Greedy tokens of granite-moe-smoke (fp32, weights x40): the
    reference's contiguous and paged runs, and the port's contiguous,
    paged, and paged without prefix sharing."""
    cfg_j, cfg_t, jp, tp = _model(ARCHS[0], "float32", 40.0)
    out = {}
    for key in (("contiguous", True), ("paged", True), ("paged", False)):
        if key[1]:
            want = je.Engine(cfg_j, jp, _scfg(je, *key)).run(_workload(je, cfg_j.vocab))
            out["ref", key[0]] = [o.tolist() for o in want]
        eng = te.Engine(cfg_t, tp, _scfg(te, *key), device="cpu")
        got = eng.run(_workload(te, cfg_t.vocab))
        assert [o.status for o in got] == [te.RequestStatus.FINISHED] * 6
        if eng.pool is not None:
            assert eng.pool.free_blocks == eng.pool.num_blocks - 1
        out["port", key] = [o.tolist() for o in got]
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_greedy_tokens_equal_reference_engine(granite_runs, layout):
    got = granite_runs["port", (layout, True)]
    assert got == granite_runs["ref", layout]
    assert len({t for o in got for t in o}) > 6  # not one token repeated per request


def test_prefix_sharing_under_moe_mirrors_the_reference(granite_runs):
    """Capacity grows with a prompt's length and a later token's overflow
    zeroes an earlier kept token, so a shared prefix's K/V past layer 0
    depends on the whole prompt.  Paged admission aliases the first
    prompt's prefix blocks, so a sharer's tokens can differ from its
    contiguous run: in the reference request 3 does here, and the port
    gives the reference's paged tokens.  Without sharing, paged equals
    contiguous."""
    ref_contig, ref_paged = granite_runs["ref", "contiguous"], granite_runs["ref", "paged"]
    differ = [i for i, (a, b) in enumerate(zip(ref_paged, ref_contig)) if a != b]
    assert differ == [3]
    assert granite_runs["port", ("paged", True)] == ref_paged
    assert granite_runs["port", ("paged", False)] == ref_contig
