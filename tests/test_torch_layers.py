"""Port parity: norms, RoPE, the MLP and ``multihead_attention``.

Seeded numpy inputs go through the reference functions and the port's.
Tolerances: float32 agrees to about 1e-5 (XLA and PyTorch sum in other
orders); bfloat16 to a few bf16 ulps at unit scale (2e-2), since both
round at the same places (a bf16 einsum returns bf16 scores that are then
cast to float32) but may round a different accumulation.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import layers as jL  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    base_j = jreg.get("smollm-360m-smoke")
    base_t = treg.get("smollm-360m-smoke")
    return (dataclasses.replace(base_j, dtype=dtype, **kw),
            dataclasses.replace(base_t, dtype=dtype, **kw))


def _pair(a, dtype="float32"):
    """numpy -> (jax, torch) with identical bits in ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_pair(jtree):
    return jtree, bridge.params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def test_rmsnorm_rope_mlp():
    cfg_j, cfg_t = _cfgs()
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 5, cfg_j.d_model)))
    scale = rng.standard_normal((cfg_j.d_model,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tL.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5)),
        _np(jL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)), **FP32,
    )
    pos = np.asarray([[0, 3, 7, 100, 4095]], np.int32)
    for j, t in zip(jL.rope_angles(jnp.asarray(pos), 16, 10000.0),
                    tL.rope_angles(torch.from_numpy(pos), 16, 10000.0)):
        np.testing.assert_allclose(_np(t), _np(j), **FP32)
    jq, tq = _pair(rng.standard_normal((1, 5, 4, 16)))
    jc, js = jL.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tL.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(_np(tL.apply_rope(tq, tc, ts)),
                               _np(jL.apply_rope(jq, jc, js)), **FP32)
    jp, tp = _tree_pair(jL.mlp_init(jax.random.PRNGKey(1), cfg_j))
    np.testing.assert_allclose(_np(tL.mlp(tp, cfg_t, tx)), _np(jL.mlp(jp, cfg_j, jx)), **FP32)


def _mha_params(cfg_j):
    return _tree_pair(jL.attention_init(jax.random.PRNGKey(2), cfg_j))


@pytest.mark.parametrize("flash", [False, True])
def test_multihead_attention_ring_cache(flash):
    """A sliding-window ring smaller than the prompt, then decode steps."""
    cfg_j, cfg_t = _cfgs(sliding_window=8)
    jp, tp = _mha_params(cfg_j)
    rng = np.random.default_rng(5)
    jc = jL.init_kv_cache(cfg_j, 2, 16, window=8)
    tc = tL.init_kv_cache(cfg_t, 2, 16, window=8, device="cpu")
    dispatch = tL.Dispatch(attention="flash" if flash else None)
    steps = [rng.standard_normal((2, 11, cfg_j.d_model))] + [
        rng.standard_normal((2, 1, cfg_j.d_model)) for _ in range(3)
    ]
    for i, x in enumerate(steps):
        jx, tx = _pair(x)
        pos = np.arange(11, dtype=np.int32) if i == 0 else None
        with jL.attention_override("flash" if flash else None):
            jy, jc = jL.multihead_attention(
                jp, cfg_j, jx, window=8, cache=jc,
                positions=None if pos is None else jnp.asarray(pos),
            )
        ty, tc = tL.multihead_attention(
            tp, cfg_t, tx, window=8, cache=tc, dispatch=dispatch,
            positions=None if pos is None else torch.from_numpy(pos),
        )
        np.testing.assert_allclose(_np(ty), _np(jy), **FP32)
        for key in ("k", "v", "pos", "len"):
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **FP32)


def test_multihead_attention_paged_cache():
    cfg_j, cfg_t = _cfgs()
    jp, tp = _mha_params(cfg_j)
    rng = np.random.default_rng(6)
    B, bs, n_blk = 3, 4, 4
    kv, hd = cfg_j.n_kv_heads, cfg_j.resolved_head_dim
    pools = [rng.standard_normal((1 + B * n_blk, bs, kv, hd)).astype(np.float32) for _ in "kv"]
    table = (rng.permutation(B * n_blk) + 1).reshape(B, n_blk).astype(np.int32)
    table[0] = table[1]  # an aliased prefix, as prefix sharing makes
    lens = np.asarray([2, 5, 13], np.int32)
    jc = {"kpool": jnp.asarray(pools[0]), "vpool": jnp.asarray(pools[1]),
          "table": jnp.asarray(table), "len": jnp.asarray(lens)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    jx, tx = _pair(rng.standard_normal((B, 1, cfg_j.d_model)))
    for flash in (False, True):
        with jL.attention_override("flash" if flash else None):
            jy, jn = jL.multihead_attention(jp, cfg_j, jx, cache=jc)
        tn = {k: v.clone() for k, v in tc.items()}
        ty, tn = tL.multihead_attention(
            tp, cfg_t, tx, cache=tn, dispatch=tL.Dispatch(attention="flash" if flash else None)
        )
        np.testing.assert_allclose(_np(ty), _np(jy), **FP32)
        for key in jn:
            np.testing.assert_allclose(_np(tn[key]), _np(jn[key]), **FP32)


