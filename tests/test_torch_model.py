"""Port parity: the dense model (prefill and decode logits, GEMM routing).

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
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    base_j = jreg.get("smollm-360m-smoke")
    base_t = treg.get("smollm-360m-smoke")
    return (dataclasses.replace(base_j, dtype=dtype, **kw),
            dataclasses.replace(base_t, dtype=dtype, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree_pair(jtree):
    return jtree, bridge.params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_and_decode_logits(dtype):
    cfg_j, cfg_t = _cfgs(dtype)
    jparams, tparams = _tree_pair(jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 16)).astype(np.int32)
    last = np.asarray([15, 4, 9], np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jm.prefill(jparams, jnp.asarray(toks), jc, last_index=jnp.asarray(last))
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks), tc, last_index=torch.from_numpy(last))
    # logits are O(0.1) at this init: compare at the output's own scale
    scale = float(np.abs(_np(jl)).max())
    tol = dict(rtol=0, atol=(1e-5 if dtype == "float32" else 2e-2) * max(scale, 1.0))
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    jc = jkv.mask_prompt_tail(jc, jnp.asarray(last + 1))
    tc = tkv.mask_prompt_tail(tc, torch.from_numpy(last + 1))
    step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
    for flash in (False, True):
        with jL.attention_override("flash" if flash else None):
            jd, _ = jm.decode_step(jparams, jnp.asarray(step), jc)
        tcc = {k: v.clone() for k, v in tc.items()}
        td, _ = tm.decode_step(tparams, torch.from_numpy(step), tcc,
                               dispatch=tL.Dispatch(attention="flash" if flash else None))
        np.testing.assert_allclose(_np(td), _np(jd), **tol)


def test_gemm_dispatch_routes_every_projection(monkeypatch):
    """``matmul="pallas"`` sends every projection and the tied
    unembedding (transposed, no copy of the table) through the GEMM
    wrapper; the CPU run takes its plain version."""
    from repro_torch.kernels.matmul import ops as mm_ops

    _, cfg_t = _cfgs()
    tm = tbuild(cfg_t)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = mm_ops.matmul
    monkeypatch.setattr(mm_ops, "matmul", lambda a, b, **kw: calls.append(kw) or real(a, b, **kw))
    toks = torch.randint(0, cfg_t.vocab, (2, 1), generator=torch.Generator().manual_seed(1))
    caches = tkv.build_caches(cfg_t, 2, 16, "cpu")
    plain, _ = tm.decode_step(params, toks, {k: v.clone() for k, v in caches.items()})
    got, _ = tm.decode_step(params, toks, caches, dispatch=tL.Dispatch(matmul="pallas"))
    # 4 attention + 3 mlp projections per layer, plus the unembedding
    assert len(calls) == 7 * cfg_t.n_layers + 1
    assert calls[-1] == {"trans_b": True}
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **FP32)
