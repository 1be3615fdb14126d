"""Port parity: the RWKV-6 family (``arch/rwkv.py``, its backbone, caches
and serving).

The same weights (the reference's ``Model.init``, moved through the bridge)
and the same seeded numpy inputs go through the reference and the port, on
``rwkv6-1.6b-smoke``.  At init ``w_lora_b`` is zero and ``w0`` constant, so
every channel would decay at the one rate ``exp(-exp(-3))``; the fixtures
overwrite both with seeded noise (the same bits in both packages) so that
the data-dependent decay is exercised.  For the token comparisons of the
engines the mixer and MLP weights are also scaled up (x20), so that the
layers move the residual stream: at init the tied unembedding of a
two-layer model returns the input token and greedy decoding repeats it.

Tolerances: fp32 to 1e-5 of the output's scale (XLA and PyTorch sum in
other orders); bf16 to 2e-2 of it (both round at the same places, a few
bf16 ulps apart at most).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import rwkv as jR  # noqa: E402
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import rwkv as tR  # noqa: E402
from repro_torch.arch import transformer as tT  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.linear_scan import ops as lsops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

ARCH = "rwkv6-1.6b-smoke"
REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreg.get(ARCH), dtype=dtype),
            dataclasses.replace(treg.get(ARCH), dtype=dtype))


def _params(cfg_j, gain=1.0, seed=0):
    """The reference's init with a seeded data-dependent decay (``w0``
    spread over [-6, -1], ``w_lora_b`` ~ N(0, 1)) and, with ``gain``, the
    mixer and MLP weights scaled; as a (jax, torch) pair with equal bits."""
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    wkv, mlp = tree["layers"]["wkv"], tree["layers"]["mlp"]
    wkv["w_lora_b"] = rng.normal(0.0, 1.0, wkv["w_lora_b"].shape).astype(wkv["w_lora_b"].dtype)
    wkv["w0"] = rng.uniform(-6.0, -1.0, wkv["w0"].shape).astype(np.float32)
    if gain != 1.0:
        for name in ("wr", "wk", "wv", "wg", "wo", "w_lora_a"):
            wkv[name] = (wkv[name] * gain).astype(wkv[name].dtype)
        for name in mlp:
            mlp[name] = (mlp[name] * gain).astype(mlp[name].dtype)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_mix_matches_reference(dtype, with_cache):
    cfg_j, cfg_t = _cfgs(dtype)
    jp, tp = _params(cfg_j)
    jw = jax.tree.map(lambda a: a[0], jp["layers"]["wkv"])
    tw = tT._index(tp["layers"]["wkv"], 0)
    rng = np.random.default_rng(1)
    B, T, D = 2, 11, cfg_j.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    jc = tc = None
    if with_cache:
        H = tR.rwkv_head_count(cfg_t)
        state = (0.1 * rng.standard_normal((B, H, 64, 64))).astype(np.float32)
        x_prev = rng.standard_normal((B, D)).astype(np.float32)
        jc = {"state": jnp.asarray(state), "x_prev": jnp.asarray(x_prev, dtype)}
        tc = {"state": torch.from_numpy(state.copy()),
              "x_prev": torch.from_numpy(x_prev).to(getattr(torch, dtype))}
    jy, jnc = jR.rwkv_mix(jw, cfg_j, jx, jc)
    ty, tnc = tR.rwkv_mix(tw, cfg_t, tx, tc)
    assert ty.dtype == tx.dtype and ty.shape == (B, T, D)
    _close(ty, jy, dtype)
    if with_cache:
        assert tnc is tc  # updated in place
        _close(tnc["state"], jnc["state"], "float32")
        assert torch.equal(tnc["x_prev"], tx[:, -1])
    else:
        assert tnc is None


def test_decay_is_data_dependent():
    """The fixtures' decay varies per token and per channel, and the port's
    streams compute it as the reference's do."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params(cfg_j)
    jw = jax.tree.map(lambda a: a[0], jp["layers"]["wkv"])
    tw = tT._index(tp["layers"]["wkv"], 0)
    x = np.random.default_rng(2).standard_normal((1, 9, cfg_j.d_model)).astype(np.float32)
    xp = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    *_, w_j = jR._streams(jw, jnp.asarray(x), jnp.asarray(xp))
    *_, w_t = tR._streams(tw, torch.from_numpy(x), torch.from_numpy(xp))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)
    w = w_t.numpy()[0]
    assert ((w > 0) & (w < 1)).all()
    assert w.std(axis=0).min() > 0  # every channel's decay moves with the token
    assert w.std(axis=1).min() > 0.01  # channels decay at different rates


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_and_decode_logits(dtype):
    cfg_j, cfg_t = _cfgs(dtype)
    jp, tp = _params(cfg_j, gain=20.0)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 13)).astype(np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    _close(tc["state"], jc["state"], dtype)
    for _ in range(2):
        step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jnp.asarray(step), jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(step), tc)
        _close(td, jd, dtype)
    _close(tc["x_prev"], jc["x_prev"], dtype)


def test_backbone_runs_one_wkv6_call_per_layer(monkeypatch):
    """Prefill and every decode step call ``ops.wkv6`` once per layer, on
    the cache's state in place; the projections of the mixer stay plain
    ``@`` under ``matmul="pallas"`` (only the MLP and the unembedding
    follow the dispatch: 3 per layer + 1)."""
    from repro_torch.arch import layers as tL
    from repro_torch.kernels.matmul import ops as mm_ops

    _, cfg_t = _cfgs()
    tm = tbuild(cfg_t)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    calls, gemms = [], []
    real, real_mm = lsops.wkv6, mm_ops.matmul
    monkeypatch.setattr(lsops, "wkv6", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(mm_ops, "matmul", lambda a, b, **kw: gemms.append(1) or real_mm(a, b, **kw))
    caches = tkv.build_caches(cfg_t, 2, 16, "cpu")
    toks = torch.randint(0, cfg_t.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    tm.prefill(params, toks, caches)
    assert calls == [{"inplace": True}] * cfg_t.n_layers
    tm.decode_step(params, toks[:, :1], caches, dispatch=tL.Dispatch(matmul="pallas"))
    assert len(calls) == 2 * cfg_t.n_layers
    assert len(gemms) == 3 * cfg_t.n_layers + 1


def _requests(mod, vocab, lens, budgets, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=b, request_id=i)
            for i, (n, b) in enumerate(zip(lens, budgets))]


def _scfg(mod, **kw):
    return mod.ServeConfig(
        max_len=32, scheduler=mod.SchedulerConfig(batch=2, prefill_bucket=16), **kw)


def test_greedy_tokens_equal_reference_engine():
    """fp32, contiguous; mixed prompt lengths (exact-length admission
    groups, one repeated) and more requests than slots."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params(cfg_j, gain=20.0)
    lens, budgets = [5, 9, 5, 12, 9, 3], [6, 4, 7, 5, 8, 3]
    want = je.Engine(cfg_j, jp, _scfg(je)).run(_requests(je, cfg_j.vocab, lens, budgets))
    eng = te.Engine(cfg_t, tp, _scfg(te), device="cpu")
    got = eng.run(_requests(te, cfg_t.vocab, lens, budgets))
    assert [o.status for o in got] == [te.RequestStatus.FINISHED] * len(lens)
    assert [o.tolist() for o in got] == [o.tolist() for o in want]
    assert [len(o) for o in got] == budgets
    assert len({t for o in got for t in o.tolist()}) > len(lens)  # not one token repeated
    assert eng.stats["peak_active"] == 2


def test_families_slot_isolation():
    """The port's copy of the reference's test of the same name, for
    rwkv6: recurrent caches survive slot admission and eviction, batched
    output == solo output, bitwise (temperature 0.5, the port's sampler)."""
    cfg = treg.get(ARCH)
    params = tbuild(cfg).init(torch.Generator().manual_seed(0), "cpu")
    scfg = te.ServeConfig(max_len=32, temperature=0.5, seed=3,
                          scheduler=te.SchedulerConfig(batch=2))
    reqs = _requests(te, cfg.vocab, [6, 9, 4], [5, 7, 4], seed=4)
    outs = te.Engine(cfg, params, scfg, device="cpu").run(reqs)
    solo = te.Engine(cfg, params, scfg, device="cpu").run([reqs[1]])[0]
    assert np.array_equal(solo, outs[1])
    assert [len(o) for o in outs] == [5, 7, 4]


@pytest.mark.parametrize("layout,abft", [("paged", "off"), ("paged", "checksum"),
                                         ("contiguous", "checksum")])
def test_paged_and_abft_raise_as_the_reference(layout, abft):
    """Paged KV is attention-only and ABFT paged-only: both packages raise
    ValueError, from the config or from the engine."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params(cfg_j)
    for mod, cfg, params, kw in ((je, cfg_j, jp, {}), (te, cfg_t, tp, {"device": "cpu"})):
        with pytest.raises(ValueError):
            scfg = _scfg(mod, kv=mod.KVConfig(layout=layout),
                         kernel=mod.KernelConfig(abft=abft))
            mod.Engine(cfg, params, scfg, **kw)


def test_caches_and_slot_axes_match_reference():
    cfg_j, cfg_t = _cfgs("bfloat16")
    want = jkv.build_caches(cfg_j, 3, 32)
    got = tkv.build_caches(cfg_t, 3, 32, "cpu")
    assert want.keys() == got.keys() == {"state", "x_prev"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name, k
        assert not got[k].any()
    assert tkv.slot_axes(cfg_t, 32) == jkv.slot_axes(cfg_j, 32) == {"state": 1, "x_prev": 1}


def test_slot_store_and_take_slot_round_trip():
    """Admission writes a batch-1 prefill cache into one slot and leaves
    the others; mask_prompt_tail leaves recurrent caches as they are."""
    _, cfg_t = _cfgs()
    axes = tkv.slot_axes(cfg_t, 32)
    big = tkv.build_caches(cfg_t, 3, 32, "cpu")
    small = tkv.build_caches(cfg_t, 2, 32, "cpu")
    g = torch.Generator().manual_seed(5)
    for k in small:
        small[k].copy_(torch.randn(small[k].shape, generator=g))
    before = {k: v.clone() for k, v in small.items()}
    assert tkv.mask_prompt_tail(small, torch.tensor([4, 2])) is small
    assert all(torch.equal(small[k], before[k]) for k in small)
    tkv.slot_store(big, tkv.take_slot(small, 1, axes), 2, axes)
    for k in big:
        assert torch.equal(big[k][:, 2], small[k][:, 1]), k
        assert not big[k][:, :2].any(), k


def test_bridge_carries_the_rwkv_tree():
    """The bf16 reference tree round-trips bit for bit, and the port's own
    init has its paths, shapes, dtypes and fixed values."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    port = bridge.params_from_jax(tree)
    back = bridge.params_to_jax(port, bf16_dtype=jnp.bfloat16)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_j.keys() == flat_b.keys()
    for path, a in flat_j.items():
        assert a.dtype == flat_b[path].dtype and a.tobytes() == flat_b[path].tobytes(), path
    own = tbuild(cfg_t).init(torch.Generator().manual_seed(0), "cpu")
    flat_t = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert flat_t.keys() == flat_j.keys()
    for path, a in flat_j.items():
        t = flat_t[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, path
    wkv = own["layers"]["wkv"]
    assert (wkv["mu"] == 0.5).all() and (wkv["w0"] == -3.0).all()
    assert not wkv["w_lora_b"].any() and (wkv["ln_scale"] == 1).all()
    assert wkv["u"].dtype == torch.float32 and abs(wkv["u"].std().item() - 0.5) < 0.15


@pytest.mark.parametrize("name", sorted(treg.ARCHS))
def test_unsupported_reason_is_none_for_every_arch(name):
    """Every architecture of the registry runs in the port; only a config
    outside the known families and mixers has a reason."""
    assert tT.unsupported_reason(treg.get(name)) is None
    assert tT.unsupported_reason(treg.get(name + "-smoke")) is None
    odd = dataclasses.replace(treg.get(name), mixer="mamba")
    assert "mamba" in tT.unsupported_reason(odd)


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                  "--new-tokens", "4", "--slots", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "statuses: FINISHED=3" in out
