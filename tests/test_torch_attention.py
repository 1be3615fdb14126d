"""Port parity: the prefill attention paths (dense, blockwise, attend).

Seeded numpy inputs go through the reference functions and the port's.
Tolerances: float32 agrees to about 1e-5 (XLA and PyTorch sum in other
orders); bfloat16 to a few bf16 ulps at unit scale (2e-2), since both
round at the same places (a bf16 einsum returns bf16 scores that are then
cast to float32) but may round a different accumulation.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import attention as jatt  # noqa: E402
from repro_torch.arch import attention as tatt  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _gqa_inputs(B, Tq, Tk, KV, G, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return (
        _pair(rng.standard_normal((B, Tq, KV, G, hd)), dtype),
        _pair(rng.standard_normal((B, Tk, KV, hd)), dtype),
        _pair(rng.standard_normal((B, Tk, KV, hd)), dtype),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_blockwise_attend(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _gqa_inputs(2, 12, 12, 2, 2, 16, dtype, seed=3)
    pos = np.arange(12, dtype=np.int32)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    tol = FP32 if dtype == "float32" else BF16
    for kw in (dict(causal=True), dict(causal=True, window=5), dict(causal=False)):
        want = jatt.dense_attention(jq, jk, jv, q_pos=jp, k_pos=jp, **kw)
        got = tatt.dense_attention(tq, tk, tv, q_pos=tp, k_pos=tp, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        for skip in (False, True):
            blk = dict(block_q=4, block_k=5, causal_skip=skip and kw["causal"])
            want_b = jatt.blockwise_attention(jq, jk, jv, q_pos=jp, k_pos=jp, **kw, **blk)
            got_b = tatt.blockwise_attention(tq, tk, tv, q_pos=tp, k_pos=tp, **kw, **blk)
            np.testing.assert_allclose(_np(got_b), _np(want_b), **tol)
        # attend's dispatch: dense below the threshold, blockwise above
        for thr in (10**6, 1):
            want_a = jatt.attend(jq, jk, jv, q_pos=jp, k_pos=jp, dense_threshold=thr, **kw)
            got_a = tatt.attend(tq, tk, tv, q_pos=tp, k_pos=tp, dense_threshold=thr, **kw)
            np.testing.assert_allclose(_np(got_a), _np(want_a), **tol)


def test_attend_ragged_decode_dispatch():
    """Per-slot positions (B, T) and the flash decode route."""
    (jq, tq), (jk, tk), (jv, tv) = _gqa_inputs(3, 1, 16, 2, 3, 16, "float32", seed=4)
    lens = np.asarray([1, 9, 16], np.int32)
    kpos = np.where(np.arange(16)[None] < lens[:, None], np.arange(16)[None], 10**9)
    qpos = (lens - 1)[:, None].astype(np.int32)
    args_j = dict(q_pos=jnp.asarray(qpos), k_pos=jnp.asarray(kpos.astype(np.int32)))
    args_t = dict(q_pos=torch.from_numpy(qpos), k_pos=torch.from_numpy(kpos.astype(np.int32)))
    oracle = jatt.attend(jq, jk, jv, **args_j)
    want = jatt.attend(jq, jk, jv, **args_j, decode_lengths=jnp.asarray(lens),
                       decode_impl="flash", decode_block=8)
    got = tatt.attend(tq, tk, tv, **args_t, decode_lengths=torch.from_numpy(lens),
                      decode_impl="flash", decode_block=8)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)
    np.testing.assert_allclose(_np(got), _np(oracle), **FP32)


