"""Port parity: AdamW and its schedule (``repro_torch.train.optim``)
against the reference's ``repro.train.optim``.

The same numpy parameters and gradients go through both packages for
three steps.  Tolerances: fp32 parameters and moments within 1e-6 of their
scale (the reference's fp32 arithmetic, fused by XLA in another order);
bf16 parameters equal after the cast, or one bf16 ulp apart where the fp32
update lands within an ulp of a rounding boundary.  The schedule within
1e-6 relative at every step 0-120.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.train import optim as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402

CFG = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)


def _tree(rng, dtype):
    return {
        "b": {"w": rng.normal(0, 0.5, (8, 16)).astype(np.float32)},
        "a": rng.normal(0, 0.5, (33,)).astype(np.float32),
        "e": {},
    } if dtype == "float32" else {
        "b": {"w": rng.normal(0, 0.5, (8, 16)).astype(jnp.bfloat16)},
        "a": rng.normal(0, 0.5, (33,)).astype(np.float32),
        "e": {},
    }


def _as_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clipped below and above 1
def test_apply_updates_matches_reference(dtype, grad_scale):
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_jax(params, device="cpu")
    jcfg, tcfg = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for step in range(3):
        g = jax.tree.map(
            lambda a: (rng.normal(0, grad_scale, a.shape)).astype(a.dtype), params)
        jp, js, jm = jopt.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp2, ts2, tm = topt.apply_updates(tcfg, tp, bridge.params_from_jax(g, device="cpu"), ts)
        assert tp2 is tp and ts2 is ts  # in place
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        for tree_j, tree_t in ((js["m"], ts["m"]), (js["v"], ts["v"])):
            for a, b in zip(jax.tree.leaves(tree_j), topt.tree_leaves(tree_t)):
                assert b.dtype == torch.float32
                w = _as_np(a)
                np.testing.assert_allclose(_as_np(b), w, rtol=0,
                                           atol=1e-6 * np.abs(w).max())
        jw, tw = _as_np(jp["b"]["w"]), _as_np(tp["b"]["w"])
        if dtype == "float32":
            np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6 * np.abs(jw).max())
        else:
            assert tp["b"]["w"].dtype == torch.bfloat16
            ulp = np.abs(jw) * 2.0**-7  # one bf16 ulp at each value (or less)
            assert (np.abs(tw - jw) <= ulp).all()
        np.testing.assert_allclose(_as_np(tp["a"]), _as_np(jp["a"]), rtol=0,
                                   atol=1e-6 * np.abs(_as_np(jp["a"])).max())


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=3e-3, warmup_steps=10, total_steps=100),
               dict(lr=1e-3, warmup_steps=0, total_steps=1, min_lr_ratio=0.2)):
        jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for s in range(121):
            want = float(jopt.lr_schedule(jc, jnp.asarray(s, jnp.int32)))
            got = float(topt.lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(0, 2, (5, 7)).astype(np.float32),
            "y": {"z": rng.normal(0, 2, (11,)).astype(np.float32)}}
    want, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    got, gn = topt.clip_by_global_norm(bridge.params_from_jax(tree), 1.0)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    assert float(topt.global_norm(got)) == pytest.approx(1.0, rel=1e-6)
    for a, b in zip(jax.tree.leaves(want), topt.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_tree_order_is_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": 3, "c": {}}
    assert topt.tree_leaves(tree) == jax.tree.leaves(tree) == [3, 2, 1]
    back = topt.tree_unflatten(tree, [30, 20, 10])
    assert back == {"a": 30, "b": {"x": 20, "y": 10}, "c": {}}
