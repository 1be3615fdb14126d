"""Port parity: the hybrid family (recurrentgemma: groups of two RG-LRU
layers and one sliding-window attention layer, then a tail of RG-LRU
layers), its caches and its serving.

The same weights (the reference's ``Model.init``, moved through the
bridge) and the same seeded numpy inputs go through the reference and the
port, on ``recurrentgemma-2b-smoke`` (4 layers: one group and one tail
layer; a window of 8, so the KV ring wraps after 8 tokens).  At init the
RG-LRU's decay is nearly zero and the layers barely move the residual
stream (the tied unembedding of a small model then returns the input
token), so the fixtures overwrite ``lam`` with seeded values in [-9, -2]
and scale every projection up (x8 for the logit tests, x20 for the token
tests), the same bits in both packages.

Tolerances: fp32 to 1e-5 of the logits' scale (XLA and PyTorch sum in
other orders); bf16 to 2e-2 of it (both round at the same places, a few
bf16 ulps apart at most).  Greedy tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch import transformer as tT  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.linear_scan import ops as lsops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

ARCH = "recurrentgemma-2b-smoke"
REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreg.get(ARCH), dtype=dtype),
            dataclasses.replace(treg.get(ARCH), dtype=dtype))


def _params(cfg_j, gain=8.0, seed=0):
    """The reference's init with a seeded slow decay and every projection
    scaled by ``gain``; as a (jax, torch) pair with equal bits."""
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    rnn_blocks = [tree["groups"]["rnn"], tree["tail"]]
    for blk in rnn_blocks:
        blk["rnn"]["lam"] = rng.uniform(-9.0, -2.0, blk["rnn"]["lam"].shape).astype(np.float32)
    for blk in rnn_blocks + [tree["groups"]["attn"]]:
        for sub in ("rnn", "attn", "mlp"):
            for name, w in blk.get(sub, {}).items():
                if name != "lam":
                    blk[sub][name] = (w * gain).astype(w.dtype)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, None subtrees as None leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_and_decode_logits(dtype):
    """A 12-token prompt (longer than the 8-slot ring: the reference keeps
    its last 8 keys) and four decode steps that wrap the ring again."""
    cfg_j, cfg_t = _cfgs(dtype)
    jp, tp = _params(cfg_j)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 12)).astype(np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    for _ in range(4):
        step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jnp.asarray(step), jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(step), tc)
        _close(td, jd, dtype)
    for path, leaf in _flat(jc).items():
        got = _flat(tc)[path]
        if path.endswith(("/pos", "/len")):
            assert np.array_equal(got.numpy(), np.asarray(leaf)), path
        else:
            _close(got, leaf, dtype)


def test_decode_kernel_path_equals_the_dense_oracle():
    """Under ``attention="flash"`` the ring's decode runs the ragged
    decode attention (its plain version here) and gives the masked dense
    path's logits, before and after the ring wraps."""
    _, cfg_t = _cfgs()
    _, tp = _params(_cfgs()[0])
    tm = tbuild(cfg_t)
    toks = torch.randint(0, cfg_t.vocab, (2, 6), generator=torch.Generator().manual_seed(2))
    flash = tL.Dispatch(attention="flash")
    ca, cb = tkv.build_caches(cfg_t, 2, 32, "cpu"), tkv.build_caches(cfg_t, 2, 32, "cpu")
    tm.prefill(tp, toks, ca)
    tm.prefill(tp, toks, cb)
    for i in range(5):
        step = toks[:, i : i + 1]
        want, _ = tm.decode_step(tp, step, ca)
        got, _ = tm.decode_step(tp, step, cb, dispatch=flash)
        _close(got, want, "float32")


def test_backbone_runs_one_scan_per_rnn_layer(monkeypatch):
    """Prefill and every decode step call ``ops.linear_scan`` once per rnn
    layer (3 of the 4), in place on the cache; the RG-LRU's projections
    stay plain ``@`` under ``matmul="pallas"`` (only the attention
    projections, the MLPs and the unembedding follow the dispatch:
    4 + 2 per layer + 1)."""
    from repro_torch.kernels.matmul import ops as mm_ops

    _, cfg_t = _cfgs()
    tm = tbuild(cfg_t)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    calls, gemms = [], []
    real, real_mm = lsops.linear_scan, mm_ops.matmul
    monkeypatch.setattr(lsops, "linear_scan",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(mm_ops, "matmul", lambda a, b, **kw: gemms.append(1) or real_mm(a, b, **kw))
    caches = tkv.build_caches(cfg_t, 2, 16, "cpu")
    toks = torch.randint(0, cfg_t.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    tm.prefill(params, toks, caches)
    n_rnn = 3
    assert calls == [{"inplace": True}] * n_rnn
    tm.decode_step(params, toks[:, :1], caches, dispatch=tL.Dispatch(matmul="pallas"))
    assert len(calls) == 2 * n_rnn
    assert len(gemms) == 4 + 2 * cfg_t.n_layers + 1


def test_caches_and_slot_axes_match_reference():
    cfg_j, cfg_t = _cfgs("bfloat16")
    want = _flat(jkv.build_caches(cfg_j, 3, 32))
    got = _flat(tkv.build_caches(cfg_t, 3, 32, "cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name, k
        assert np.array_equal(_np(got[k]), np.asarray(want[k]).astype(np.float32)), k
    # ring of the window size, not max_len
    assert got["/groups/attn/k"].shape[2] == cfg_t.sliding_window
    assert tkv.slot_axes(cfg_t, 32) == jkv.slot_axes(cfg_j, 32)
    assert tkv.slot_axes(cfg_t, 32)["groups"]["rnn"]["h"] == 2
    assert tkv.slot_axes(cfg_t, 32)["groups"]["attn"]["k"] == 1
    # a model without a tail: the reference's None subtree
    cj, ct = (dataclasses.replace(c, n_layers=3) for c in (cfg_j, cfg_t))
    assert tkv.build_caches(ct, 2, 16, "cpu")["tail"] is None
    assert tkv.slot_axes(ct, 16) == jkv.slot_axes(cj, 16)


def test_slot_store_and_take_slot_round_trip():
    """The port's copy of the reference's test of the same name: a batch-1
    cache of ones stored into slot 1 comes back out, the other slots are
    untouched; mask_prompt_tail leaves the recurrent leaves alone."""
    _, cfg = _cfgs()
    axes = tkv.slot_axes(cfg, 16)
    big = tkv.build_caches(cfg, 3, 16, "cpu")
    before = tkv._tree_map(torch.clone, big)
    small = tkv._tree_map(lambda leaf, ax: torch.ones_like(leaf.narrow(ax, 0, 1)), big, axes)
    assert tkv.slot_store(big, small, 1, axes) is big
    got = _flat(tkv.take_slot(big, 1, axes))
    for k, v in _flat(small).items():
        assert torch.equal(got[k], v), k
    other = _flat(tkv.take_slot(big, 0, axes))
    ref = _flat(tkv.take_slot(before, 0, axes))
    for k in other:
        assert torch.equal(other[k], ref[k]), k
    tkv.mask_prompt_tail(small, torch.tensor([3]))
    flat = _flat(small)
    assert (flat["/tail/h"] == 1).all() and (flat["/groups/rnn/conv"] == 1).all()
    assert (flat["/groups/attn/len"] == 3).all()
    assert (flat["/groups/attn/pos"][..., 3:] == 10**9).all()


def _requests(mod, vocab, lens, budgets, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=b, request_id=i)
            for i, (n, b) in enumerate(zip(lens, budgets))]


def _scfg(mod, attention="flash", **kw):
    return mod.ServeConfig(
        max_len=32, scheduler=mod.SchedulerConfig(batch=2, prefill_bucket=16),
        kernel=mod.KernelConfig(attention=attention), **kw)


@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_greedy_tokens_equal_reference_engine(attention):
    """fp32, contiguous; mixed prompt lengths (exact-length admission
    groups, one repeated), more requests than slots, and every request's
    prompt plus new tokens past the window of 8, so each ring wraps (the
    12-token prompt already at prefill)."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params(cfg_j, gain=20.0)
    lens, budgets = [5, 9, 5, 12, 3, 7], [6, 4, 7, 5, 9, 8]
    want = je.Engine(cfg_j, jp, _scfg(je, attention)).run(
        _requests(je, cfg_j.vocab, lens, budgets))
    eng = te.Engine(cfg_t, tp, _scfg(te, attention), device="cpu")
    got = eng.run(_requests(te, cfg_t.vocab, lens, budgets))
    assert [o.status for o in got] == [te.RequestStatus.FINISHED] * len(lens)
    assert [o.tolist() for o in got] == [o.tolist() for o in want]
    assert [len(o) for o in got] == budgets
    assert all(n + b > cfg_t.sliding_window for n, b in zip(lens, budgets))
    assert len({t for o in got for t in o.tolist()}) > len(lens)  # not one token repeated
    assert eng.stats["peak_active"] == 2


def test_families_slot_isolation():
    """The port's copy of the reference's test of the same name, for
    recurrentgemma: ring and recurrent caches survive slot admission and
    eviction, batched output == solo output, bitwise (temperature 0.5, the
    port's sampler)."""
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
    """Paged KV is global-attention-only and ABFT paged-only: both packages
    raise ValueError, from the config or from the engine."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params(cfg_j)
    for mod, cfg, params, kw in ((je, cfg_j, jp, {}), (te, cfg_t, tp, {"device": "cpu"})):
        with pytest.raises(ValueError):
            scfg = mod.ServeConfig(
                max_len=32, scheduler=mod.SchedulerConfig(batch=2),
                kv=mod.KVConfig(layout=layout), kernel=mod.KernelConfig(abft=abft))
            mod.Engine(cfg, params, scfg, **kw)


def test_bridge_carries_the_hybrid_tree():
    """The bf16 reference tree round-trips bit for bit, and the port's own
    init has its paths, shapes and dtypes."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    back = bridge.params_to_jax(bridge.params_from_jax(tree), bf16_dtype=jnp.bfloat16)
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
    assert list(own) == ["embed", "groups", "tail", "final_ln"]  # the reference's init order
    lam = own["groups"]["rnn"]["rnn"]["lam"]
    assert lam.dtype == torch.float32 and lam.shape == (1, 2, cfg_t.rnn_width)


def test_unsupported_reason_is_none_for_the_hybrid_family():
    assert tT.unsupported_reason(treg.get("recurrentgemma-2b")) is None
    assert tT.unsupported_reason(treg.get(ARCH)) is None


def test_launcher_serves_recurrentgemma_on_the_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                  "--new-tokens", "12", "--slots", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "statuses: FINISHED=3" in out
