"""Port parity: ragged decode attention (plain versions and CUDA wrappers).

The same numpy inputs (seeded) go through the reference's jnp twins
(``decode_attention_xla`` / ``_paged_xla``), its Pallas kernels in
interpret mode (``flash_decode_pallas`` / ``flash_decode_paged_pallas``)
and the port's plain versions.  Tolerances: fp32 agrees to ~1e-5
(summation order differs between XLA and torch), bf16 to a few bf16 ulps
(2e-2 absolute on unit-scale outputs).  Within the port, plain paged must
equal plain contiguous bitwise at ``bk == block_size``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import decode_attention as jdec  # noqa: E402
from repro_torch.kernels.flash_attention import decode_attention as tdec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)   # summation order only
BF16 = dict(rtol=2e-2, atol=2e-2)   # a few bf16 ulps at unit scale


def _inputs(B, S, KV, G, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, d), np.float32)
    k = rng.standard_normal((B, S, KV, d), np.float32)
    v = rng.standard_normal((B, S, KV, d), np.float32)
    return q, k, v


def _to_pair(a, dtype):
    """One numpy array as a (jax, torch) pair of ``dtype`` with identical
    bits (bf16 rounds once, in numpy, through jax)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _paged_from_contiguous(k, v, bs, seed=0):
    """Scatter a contiguous (B, S, KV, d) cache into a shuffled block pool
    (block 0 left as a garbage sink) with per-row block tables."""
    B, S = k.shape[:2]
    n_blk = S // bs
    rng = np.random.default_rng(seed)
    phys = rng.permutation(B * n_blk) + 1
    tables = phys.reshape(B, n_blk).astype(np.int32)
    kpool = rng.standard_normal((B * n_blk + 1, bs) + k.shape[2:], np.float32)
    vpool = rng.standard_normal(kpool.shape, np.float32)
    for b in range(B):
        for j in range(n_blk):
            kpool[tables[b, j]] = k[b, j * bs : (j + 1) * bs]
            vpool[tables[b, j]] = v[b, j * bs : (j + 1) * bs]
    return kpool, vpool, tables


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 3])
def test_plain_contiguous_matches_reference(G, dtype):
    B, S, KV, d, bk = 4, 32, 2, 16, 8
    q, k, v = _inputs(B, S, KV, G, d, seed=G)
    lengths = np.asarray([0, 7, 13, 32], np.int32)  # 0 attends one key
    (jq, tq), (jk, tk), (jv, tv) = (_to_pair(a, dtype) for a in (q, k, v))
    want_xla = jdec.decode_attention_xla(jq, jk, jv, jnp.asarray(lengths), bk=bk)
    want_pl = jdec.flash_decode_pallas(
        jq, jk, jv, jnp.asarray(lengths), bk=bk, interpret=True
    )
    got = tdec.decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths), bk=bk)
    tol = FP32 if dtype == jnp.float32 else BF16
    np.testing.assert_allclose(_np(got), _np(want_xla), **tol)
    np.testing.assert_allclose(_np(got), _np(want_pl), **tol)
    # the dense oracle, where a length of 0 is a fully masked row
    ref = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(np.maximum(lengths, 1)))
    np.testing.assert_allclose(_np(got), _np(ref), **tol)
    # the wrapper takes the plain version for CPU tensors
    wrapped = tdec.flash_decode_cuda(tq, tk, tv, torch.from_numpy(lengths), bk=bk)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_paged_matches_reference(G, window):
    B, S, KV, d, bs = 3, 32, 2, 16, 8
    q, k, v = _inputs(B, S, KV, G, d, seed=10 + G)
    kpool, vpool, tables = _paged_from_contiguous(k, v, bs, seed=G)
    lengths = np.asarray([0, 19, 32], np.int32)
    args_j = [jnp.asarray(a) for a in (q, kpool, vpool, tables, lengths)]
    want_xla = jdec.decode_attention_paged_xla(*args_j, window=window)
    want_pl = jdec.flash_decode_paged_pallas(*args_j, window=window, interpret=True)
    args_t = [torch.from_numpy(a) for a in (q, kpool, vpool, tables, lengths)]
    got = tdec.decode_attention_paged_plain(*args_t, window=window)
    np.testing.assert_allclose(_np(got), _np(want_xla), **FP32)
    np.testing.assert_allclose(_np(got), _np(want_pl), **FP32)
    ref = tref.decode_attention_paged_ref(
        *[torch.from_numpy(a) for a in (q, kpool, vpool, tables, np.maximum(lengths, 1))],
        window=window,
    )
    np.testing.assert_allclose(_np(got), _np(ref), **FP32)


def test_plain_paged_aliased_tables():
    """Rows whose tables alias the same prefix blocks (prefix sharing) read
    the same keys: their outputs agree where their queries do."""
    B, KV, G, d, bs = 3, 2, 2, 16, 4
    rng = np.random.default_rng(3)
    q = np.repeat(rng.standard_normal((1, KV, G, d), np.float32), B, axis=0)
    kpool = rng.standard_normal((9, bs, KV, d), np.float32)
    vpool = rng.standard_normal((9, bs, KV, d), np.float32)
    tables = np.asarray([[1, 2, 3, 0], [1, 2, 3, 0], [1, 2, 4, 5]], np.int32)
    lengths = np.asarray([11, 11, 15], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, kpool, vpool, tables, lengths)]
    got = tdec.decode_attention_paged_plain(*args_t)
    assert torch.equal(got[0], got[1])
    want = jdec.flash_decode_paged_pallas(
        *[jnp.asarray(a) for a in (q, kpool, vpool, tables, lengths)], interpret=True
    )
    np.testing.assert_allclose(_np(got), _np(want), **FP32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_paged_bitwise_equals_contiguous(dtype):
    """At bk == block_size the two plain versions run the same reduction
    over the same logical keys: bitwise equal."""
    B, S, KV, G, d, bs = 4, 48, 2, 3, 16, 16
    q, k, v = _inputs(B, S, KV, G, d, seed=7)
    kpool, vpool, tables = _paged_from_contiguous(k, v, bs, seed=7)
    lengths = torch.tensor([1, 16, 17, 48], dtype=torch.int32)
    tq, tk, tv, tkp, tvp = (torch.from_numpy(a).to(dtype) for a in (q, k, v, kpool, vpool))
    contig = tops.decode_attention(tq, tk, tv, lengths, bk=bs, impl="plain")
    paged = tops.decode_attention_paged(
        tq, tkp, tvp, torch.from_numpy(tables), lengths, impl="plain"
    )
    assert torch.equal(contig, paged)


def test_batched_equals_solo_bitwise():
    """A row's output does not depend on the rows batched with it (dead
    splits of shorter rows contribute exactly zero)."""
    B, S, KV, G, d = 3, 32, 2, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, KV, G, d, seed=5))
    lengths = torch.tensor([4, 19, 32], dtype=torch.int32)
    batched = tdec.decode_attention_plain(q, k, v, lengths, bk=8)
    for i in range(B):
        solo = tdec.decode_attention_plain(
            q[i : i + 1], k[i : i + 1], v[i : i + 1], lengths[i : i + 1], bk=8
        )
        assert torch.equal(solo[0], batched[i]), i


def test_pick_decode_bk_divides_and_caps():
    for S in (1, 7, 16, 48, 64, 96, 1000, 1024):
        b = tops._pick_decode_bk(S)
        assert S % b == 0 and 1 <= b <= 64
    assert tops._pick_decode_bk(1024) == 64


def test_wrappers_reject_other_devices_and_impls():
    q = torch.zeros((1, 1, 1, 64), device="meta")
    k = torch.zeros((1, 16, 1, 64), device="meta")
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tdec.flash_decode_cuda(q, k, k, lens, bk=16)
    with pytest.raises(ValueError):
        tops.decode_attention(q, k, k, lens, impl="xla")
