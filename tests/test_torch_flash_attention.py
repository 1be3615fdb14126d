"""Port parity: flash attention (``kernels/flash_attention``, ``ops.flash_attention``).

The same seeded numpy inputs go through the reference's
``repro.kernels.flash_attention.ops.flash_attention`` (its Pallas kernel in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and the
port's ``ops.flash_attention`` (the plain version on the CPU), in both of
the reference's variants: static (offset 0, every key block visited) and
dynamic (``q_offset``/``kv_len``, dead blocks skipped).  Tolerances: fp32
within 1e-5 absolute at unit-normal inputs (fp32 sums in other orders);
bf16 with each (b, t, head) row's ||got - want|| within 1e-2 of its
||want|| (both round p to bf16 before the P.V product and the output to
bf16, at scores that may differ in the last fp32 bit; a row is held to
its own scale because late rows, which average many keys, are far
smaller than early ones).  A query with no live key is the mean of the V rows
the reference visits (its masked scores are the finite -1e30), which
depends on the reference's ``bk`` and variant: the port reproduces it.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tref  # noqa: E402

FP32_ATOL = 1e-5
BF16_OF_ROW = 1e-2


def _inputs(B, Tq, Tk, KV, G, d, dtype, seed=0):
    """Unit-normal q (B, Tq, KV, G, d), k and v (B, Tk, KV, d) as (jax,
    torch) pairs with identical bits (bf16 rounds once, through jax)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Tq, KV, G, d), np.float32),
              rng.standard_normal((B, Tk, KV, d), np.float32),
              rng.standard_normal((B, Tk, KV, d), np.float32))
    pairs = []
    for a in arrays:
        j = jnp.asarray(a).astype(dtype)
        t = torch.from_numpy(np.array(j.astype(jnp.float32)))
        pairs.append((j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)))
    return pairs


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == jnp.float32:
        err = float(np.abs(got - want).max())
        assert err <= FP32_ATOL, err
    else:
        rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert float(rows.max()) <= BF16_OF_ROW, float(rows.max())


def _both(pairs, **kw):
    (jq, tq), (jk, tk), (jv, tv) = pairs
    want = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    got = tops.flash_attention(tq, tk, tv, **kw)
    return got, want


# ------------------------------------------------------- the reference's grid


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("Tq,Tk,window", [
    (128, 128, None), (256, 256, None), (128, 128, 32), (64, 192, None),
])
def test_matches_reference_on_its_grid(Tq, Tk, window, dtype):
    """``tests/test_kernels.py::test_flash_attention``'s cases, bq = bk = 64."""
    pairs = _inputs(2, Tq, Tk, 2, 2, 32, dtype, seed=Tq + Tk)
    got, want = _both(pairs, window=window, bq=64, bk=64)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matches_reference_cached_decode(dtype):
    """The dynamic variant: 8 queries at offset 100 over kv_len 108 of 128."""
    pairs = _inputs(1, 8, 128, 1, 2, 32, dtype, seed=5)
    got, want = _both(pairs, q_offset=100, kv_len=108, bq=8, bk=64)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("d", [16, 240, 256])
def test_matches_reference_at_every_group_and_head_dim(G, d, dtype):
    """The -smoke head_dim 16, gemma3-12b's 240, recurrentgemma-2b's 256;
    default bq/bk (each capped at its extent), both variants."""
    pairs = _inputs(1, 24, 40, 2, G, d, dtype, seed=G * d)
    got, want = _both(pairs)
    _assert_close(got, want, dtype)
    got, want = _both(pairs, q_offset=16, kv_len=37)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(causal=False, window=12, bq=16, bk=16),       # keys on both sides of the query
    dict(causal=False, bk=24),                         # full attention, a padded last block
    dict(window=20, bk=32, q_offset=30, kv_len=100),   # a chunk over a longer cache
])
def test_matches_reference_noncausal_windows_and_padding(kw, dtype):
    pairs = _inputs(2, 48, 70, 1, 2, 32, dtype, seed=7)
    got, want = _both(pairs, **kw)
    _assert_close(got, want, dtype)


# ----------------------------------------------------- queries with no live key


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", ["static", "dynamic"])
def test_rows_with_no_live_key_match_the_reference(case, dtype):
    """Static: 64 queries over 40 keys, window 16, bk 32 -- queries from 55
    on see no key; the reference visits 64 keys (24 of them its zero
    padding), so such a row is sum(V) / 64.  Dynamic: offset 100, kv_len
    40, window 16 -- no query sees a key; with bk 16 the reference visits
    keys [0, 48), live or not, so every row is the mean of V[0:48]."""
    if case == "static":
        pairs = _inputs(1, 64, 40, 1, 2, 16, dtype, seed=11)
        kw, dead, visited = dict(window=16, bk=32), slice(55, 64), 64
    else:
        pairs = _inputs(1, 8, 64, 1, 2, 16, dtype, seed=12)
        kw, dead, visited = dict(window=16, q_offset=100, kv_len=40, bk=16), slice(0, 8), 48
    got, want = _both(pairs, **kw)
    _assert_close(got, want, dtype)
    v = pairs[2][1].float()[0, :, 0]  # (Tk, d)
    mean = v[:visited].sum(0) / visited
    dead_rows = got[0, dead].float()  # (rows, KV=1, G=2, d)
    tol = FP32_ATOL if dtype == jnp.float32 else BF16_OF_ROW * float(mean.abs().max())
    assert float((dead_rows - mean).abs().max()) <= tol


# ------------------------------------------------------ plain version, oracle


@pytest.mark.parametrize("window", [None, 9])
def test_plain_matches_the_dense_oracles(window):
    """The port's plain version against its dense oracle and the
    reference's, on flattened heads with K/V repeated per query head."""
    B, T, KV, G, d = 2, 33, 2, 3, 16
    (jq, tq), (jk, tk), (jv, tv) = _inputs(B, T, T, KV, G, d, jnp.float32, seed=3)
    got = tops.flash_attention(tq, tk, tv, window=window, bk=8)
    qf = tq.permute(0, 2, 3, 1, 4).reshape(B * KV * G, T, d)
    kf, vf = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(B * KV * G, T, d)
              for t in (tk, tv))
    want = tref(qf, kf, vf, window=window).reshape(B, KV, G, T, d).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32_ATOL, rtol=0)
    j_want = np.asarray(jref(jnp.asarray(qf.numpy()), jnp.asarray(kf.numpy()),
                             jnp.asarray(vf.numpy()), window=window))
    np.testing.assert_allclose(want.reshape(B, T, KV, G, d).numpy(),
                               j_want.reshape(B, KV, G, T, d).transpose(0, 3, 1, 2, 4),
                               atol=FP32_ATOL, rtol=0)


def test_key_bounds_follow_the_reference_variants():
    assert tfa.key_bounds(40, 32, None) == (40, 64)      # static: padded last block
    assert tfa.key_bounds(128, 64, 108) == (108, 128)    # dynamic: blocks below kv_len
    assert tfa.key_bounds(64, 16, 40) == (40, 48)
    assert tfa.key_bounds(64, 16, 500) == (64, 64)       # kv_len clamped to Tk
    assert tfa.key_bounds(64, 16, 0) == (0, 0)           # nothing visited: output 0


# ----------------------------------------------------------------- wrappers


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (_, tq), (_, tk), (_, tv) = _inputs(1, 16, 16, 1, 2, 16, jnp.float32, seed=2)
    before = tfa.flash_attention_cuda.launches
    got = tops.flash_attention(tq, tk, tv)
    assert tfa.flash_attention_cuda.launches == before
    assert torch.equal(got, tops.flash_attention(tq, tk, tv, impl="plain"))


def test_wrappers_reject_other_devices_and_impls():
    """Neither the wrapper nor the entry point falls back to the plain
    version for a tensor that is neither on the CPU nor on the card."""
    q = torch.zeros((1, 8, 1, 2, 16), device="meta")
    k = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q.reshape(1, 8, 2, 16).transpose(1, 2), k.transpose(1, 2),
                                 k.transpose(1, 2), bk=8)
    c = torch.zeros((1, 8, 1, 2, 16))
    with pytest.raises(ValueError):
        tops.flash_attention(c, c[:, :, :, 0], c[:, :, :, 0], impl="pallas")
