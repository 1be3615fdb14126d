"""Port parity: the RG-LRU recurrent block (``arch/rglru.py``).

The same weights (one rnn layer of the reference's ``Model.init`` on
``recurrentgemma-2b-smoke``, moved through the bridge) and the same seeded
numpy inputs go through the reference and the port.  At init the block's
decay is nearly zero (``a = exp(-8 softplus(lam) sigmoid(.))`` with ``lam``
in [0.9, 4] gives a < 0.01) and its projections tiny, so the fixtures
overwrite ``lam`` with seeded values in [-9, -2] (a between about 0.6 and
1, so the state carries over many steps) and scale the projections and the
conv kernel up (x8), the same bits in both packages.

Tolerances: fp32 to 1e-5 of the output's scale (XLA and PyTorch sum and
round the fp32 gates in other orders); bf16 to 2e-2 of it (both round the
model-dtype projections, GeLU and conv at the same places, a few bf16 ulps
apart at most).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import rglru as jG  # noqa: E402
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import rglru as tG  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels.linear_scan import ops as lsops  # noqa: E402

ARCH = "recurrentgemma-2b-smoke"
REL = {"float32": 1e-5, "bfloat16": 2e-2}
GAIN = 8.0


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jreg.get(ARCH), dtype=dtype, **kw),
            dataclasses.replace(treg.get(ARCH), dtype=dtype, **kw))


def _rnn_params(cfg_j, seed=0):
    """Layer (0, 0) of the reference init's rnn groups with a seeded slow
    decay and scaled projections, as a (jax, torch) pair with equal bits."""
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(seed)))
    p = jax.tree.map(lambda a: np.ascontiguousarray(a[0, 0]), tree["groups"]["rnn"]["rnn"])
    rng = np.random.default_rng(seed + 100)
    p["lam"] = rng.uniform(-9.0, -2.0, p["lam"].shape).astype(np.float32)
    for name in ("w_y", "w_x", "w_a", "w_i", "w_o", "conv"):
        p[name] = (p[name] * GAIN).astype(p[name].dtype)
    return jax.tree.map(jnp.asarray, p), bridge.params_from_jax(p, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


def _caches(cfg, B, rng, dtype):
    w, K = cfg.rnn_width, cfg.conv1d_width
    h = (0.5 * rng.standard_normal((B, w))).astype(np.float32)
    conv = rng.standard_normal((B, K - 1, w)).astype(np.float32)
    jc = {"h": jnp.asarray(h), "conv": jnp.asarray(conv, dtype)}
    tc = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(conv).to(getattr(torch, dtype))}
    return jc, tc


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_reference(dtype, with_cache):
    cfg_j, cfg_t = _cfgs(dtype)
    jp, tp = _rnn_params(cfg_j)
    rng = np.random.default_rng(1)
    B, T, D = 2, 11, cfg_j.d_model
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    jc, tc = _caches(cfg_j, B, rng, dtype) if with_cache else (None, None)
    jy, jnc = jG.rglru_block(jp, cfg_j, jx, jc)
    ty, tnc = tG.rglru_block(tp, cfg_t, tx, tc)
    assert ty.dtype == tx.dtype and ty.shape == (B, T, D)
    _close(ty, jy, dtype)
    if with_cache:
        assert tnc is tc  # updated in place
        _close(tnc["h"], jnc["h"], dtype)
        assert tnc["h"].dtype == torch.float32
        assert np.array_equal(_np(tnc["conv"]), _np(jnc["conv"]))  # copied values
    else:
        assert tnc is None


def test_decode_steps_continue_the_prefill():
    """A prefill and three one-token steps through the cache equal the
    reference's, and equal the port's own uncached pass over the whole
    sequence (the cache carries h and the conv history exactly)."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _rnn_params(cfg_j, seed=2)
    rng = np.random.default_rng(3)
    B, D = 2, cfg_j.d_model
    x = rng.standard_normal((B, 9, D)).astype(np.float32)
    zeros = {"h": np.zeros((B, cfg_j.rnn_width), np.float32),
             "conv": np.zeros((B, cfg_j.conv1d_width - 1, cfg_j.rnn_width), np.float32)}
    jc = jax.tree.map(jnp.asarray, zeros)
    tc = {k: torch.from_numpy(v.copy()) for k, v in zeros.items()}
    ys_j, ys_t = [], []
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jy, jc = jG.rglru_block(jp, cfg_j, jnp.asarray(x[:, lo:hi]), jc)
        ty, tc = tG.rglru_block(tp, cfg_t, torch.from_numpy(x[:, lo:hi]), tc)
        _close(ty, jy, "float32")
        ys_j.append(_np(jy))
        ys_t.append(ty)
    whole, _ = tG.rglru_block(tp, cfg_t, torch.from_numpy(x))
    _close(torch.cat(ys_t, dim=1), whole, "float32")
    _close(tc["h"], jc["h"], "float32")


@pytest.mark.parametrize("T", [1, 2, 3, 5])
def test_conv_history_when_T_is_short(T):
    """The history returned is the last K-1 rows of [prev, z], which for
    T < K-1 still holds rows of the previous history."""
    rng = np.random.default_rng(T)
    B, K, W = 2, 4, 8
    z, kern = rng.standard_normal((B, T, W)), rng.standard_normal((K, W))
    prev = rng.standard_normal((B, K - 1, W))
    j_out, j_hist = jG._causal_conv1d(*(jnp.asarray(a, jnp.float32) for a in (z, kern, prev)))
    t_out, t_hist = tG._causal_conv1d(*(torch.tensor(a, dtype=torch.float32)
                                        for a in (z, kern, prev)))
    assert t_hist.shape == (B, K - 1, W)
    np.testing.assert_array_equal(t_hist.numpy(), np.asarray(j_hist))
    want_hist = np.concatenate([prev, z], axis=1)[:, -(K - 1):].astype(np.float32)
    np.testing.assert_array_equal(t_hist.numpy(), want_hist)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T", [1, 40, 70])
def test_rglru_scan_matches_reference(T):
    """The reference pads T to its 64-step chunks with a = 1, gx = 0; the
    port scans T once."""
    rng = np.random.default_rng(T + 10)
    B, W = 2, 24
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32)
    gx = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    j_out, j_h = jG.rglru_scan(*map(jnp.asarray, (a, gx, h0)))
    t_out, t_h = tG.rglru_scan(*map(torch.from_numpy, (a, gx, h0)))
    assert t_out.shape == (B, T, W)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), rtol=1e-5, atol=1e-5)


def test_block_runs_one_scan_on_the_cache_state_in_place(monkeypatch):
    """One ``ops.linear_scan`` call per block, fp32 operands, on the cache's
    own ``h`` (in place) or on fresh zeros without a cache."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    _, tp = _rnn_params(cfg_j)
    calls = []
    real = lsops.linear_scan
    monkeypatch.setattr(lsops, "linear_scan",
                        lambda a, x, h0, **kw: calls.append((a, x, h0, kw)) or real(a, x, h0, **kw))
    x = torch.randn((2, 5, cfg_t.d_model), generator=torch.Generator().manual_seed(0))
    cache = tG.rglru_init_cache(cfg_t, 2)
    tG.rglru_block(tp, cfg_t, x.bfloat16(), cache)
    tG.rglru_block(tp, cfg_t, x.bfloat16())
    assert [c[3] for c in calls] == [{"inplace": True}, {"inplace": False}]
    assert calls[0][2] is cache["h"]
    assert all(t.dtype == torch.float32 for c in calls for t in c[:3])
    a = calls[0][0]
    assert bool(((a > 0) & (a < 1)).all())


def test_init_draws_the_reference_distributions():
    """With rnn_width != d_model: projections normal 0.02/sqrt(d_model), not
    /sqrt(width); the conv kernel normal 0.02; ``lam`` fp32 linspace(0.9,
    4.0); shapes and dtypes as the reference's."""
    cfg_j, cfg_t = _cfgs("bfloat16", d_model=128, rnn_width=192)
    want = jG.rglru_init(jax.random.PRNGKey(0), cfg_j)
    got = tG.rglru_init(torch.Generator().manual_seed(0), cfg_t, lead=(3,))
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == (3,) + v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == v.dtype.name, k
    np.testing.assert_allclose(got["lam"][1].numpy(), np.asarray(want["lam"]), rtol=1e-6)
    for k in ("w_y", "w_x", "w_a", "w_i", "w_o"):
        assert abs(got[k].float().std().item() - 0.02 / 128**0.5) < 2e-4, k
    assert abs(got["conv"].float().std().item() - 0.02) < 4e-3
