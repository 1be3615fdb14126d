"""Port parity: the ABFT checks (``repro_torch.kernels.abft``) and the
checksum GEMM's plain version against the reference's.

Inputs come from numpy seeds and cross into both packages unchanged.
Tolerances: fp32 products and checksums to 1e-5 relative to their
abs-sum scale (the two sides sum in other orders); bf16 products to one
bf16 ulp of the output scale (both accumulate in fp32 and round once);
bit flips and verdicts exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import abft as jabft  # noqa: E402
from repro.kernels.matmul.matmul import matmul_pallas_abft  # noqa: E402
from repro_torch.kernels import abft  # noqa: E402
from repro_torch.kernels.matmul import ops as tops  # noqa: E402
from repro_torch.kernels.matmul.matmul import (  # noqa: E402
    abft_block_rows,
    matmul_abft_cuda,
    matmul_abft_plain,
)

BF16_ULP = 2.0**-7


def _to_torch(x):
    """A JAX or numpy array as a CPU tensor, bf16 bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _operands(M, K, N, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (M, K)).astype(np.float32)
    b = rng.uniform(-1, 1, (K, N)).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    return jnp.asarray(a), jnp.asarray(b)


def _pallas_abft(a, b, bm, bn=16, bk=16):
    """The reference checksum kernel in interpret mode, zero-padded to its
    blocks (zero rows and columns are checksum-neutral)."""
    M, K = a.shape
    N = b.shape[1]
    ap = jnp.pad(a, ((0, (-M) % bm), (0, (-K) % bk)))
    bp = jnp.pad(b, ((0, (-K) % bk), (0, (-N) % bn)))
    out, checks = matmul_pallas_abft(ap, bp, bm=bm, bn=bn, bk=bk, interpret=True)
    return np.asarray(out[:M, :N].astype(jnp.float32)), np.asarray(checks[:, :N])


# ------------------------------------------------------- checksum GEMM --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [(9, 48, 40), (16, 32, 70), (17, 64, 33), (70, 40, 24)])
def test_plain_matches_pallas_abft(M, K, N, trans_b, dtype):
    """Product and per-row-block checksums, with the reference's ``bm``
    pinned to the port kernel's row tile (16 for M <= 16, else 64)."""
    ja, jb = _operands(M, K, N, seed=M * 7 + K + N, dtype=dtype)
    bm = abft_block_rows(M)
    want_out, want_checks = _pallas_abft(ja, jb, bm)
    ta, tb = _to_torch(ja), _to_torch(jb)
    if trans_b:
        tb = tb.T.contiguous()
    out, checks = matmul_abft_plain(ta, tb, trans_b=trans_b)
    got_out, _ = tops.matmul_abft(ta, tb, trans_b=trans_b)
    assert torch.equal(got_out, out)  # the CPU wrapper takes the plain version
    assert checks.shape == (-(-M // bm), N) and checks.dtype == torch.float32
    a32, b32 = np.asarray(ja, np.float32), np.asarray(jb, np.float32)
    pad = -(-M // bm) * bm - M
    scale = np.abs(np.pad(a32, ((0, pad), (0, 0)))).reshape(-1, bm, K).sum(1) @ np.abs(b32)
    np.testing.assert_array_less(np.abs(checks.numpy() - want_checks), 1e-6 + 1e-5 * scale)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    else:
        ulp = BF16_ULP * np.abs(want_out).max()
        np.testing.assert_allclose(out.float().numpy(), want_out, rtol=0, atol=ulp)


def test_cpu_wrapper_counts_no_launch():
    a = torch.ones((3, 8))
    before = matmul_abft_cuda.launches
    out, checks = matmul_abft_cuda(a, torch.ones((8, 5)))
    assert matmul_abft_cuda.launches == before
    assert torch.equal(checks, torch.full((1, 5), 24.0))


# ------------------------------------------------------- fingerprints --
@pytest.fixture(scope="module")
def smol_params():
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro_torch import bridge

    cfg = jreg.get("smollm-360m-smoke")
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def test_weight_sums_match_reference(smol_params):
    """One fp32 abs-sum per leaf, in the reference's leaf order; the two
    sum in other orders, hence 1e-5 relative."""
    jparams, tparams = smol_params
    want = np.asarray(jax.jit(jabft.weight_sums)(jparams))
    got = abft.weight_sums(tparams)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert torch.equal(abft.weight_sums(tparams), got)  # repeats bit for bit


def test_weight_colstats_match_reference(smol_params):
    jparams, tparams = smol_params
    want = jax.jit(jabft.weight_colstats)(jparams)
    got = abft.weight_colstats(tparams)
    assert sorted(got) == sorted(want)
    for key, (colabs, colmax) in got.items():
        np.testing.assert_allclose(colabs.numpy(), np.asarray(want[key][0]), rtol=1e-5)
        np.testing.assert_array_equal(colmax.numpy(), np.asarray(want[key][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "row,col,bit", [(0, -1, 27), (3, -1, 30), (5, 7, 23), (9, 2, 16), (2, -1, 31), (4, 1, 3)]
)
def test_maybe_flip_bitwise_equal_to_reference(row, col, bit, dtype):
    rng = np.random.default_rng(row * 31 + bit)
    x = rng.standard_normal((6, 11)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    fault = np.array([abft.FAULT_MATMUL, 4, row, col, bit, 2, 0, 0], np.int32)
    want = jabft._maybe_flip(jx, jnp.asarray(fault), abft.FAULT_MATMUL, 4, jnp.bool_(True))
    got = abft._maybe_flip(_to_torch(jx), fault, abft.FAULT_MATMUL, 4, True)
    assert torch.equal(got, _to_torch(want))
    # bits below 16 of a bf16 value round away on the way back, in both
    changed = dtype == "float32" or bit >= 16
    assert torch.equal(got, _to_torch(jx)) != changed
    # another site, call or a closed gate leaves the operand untouched
    for site, idx, gate in ((abft.FAULT_ATTENTION, 4, True), (abft.FAULT_MATMUL, 3, True),
                            (abft.FAULT_MATMUL, 4, False)):
        assert torch.equal(abft._maybe_flip(_to_torch(jx), fault, site, idx, gate), _to_torch(jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_check_verdicts_match_reference(dtype):
    for seed in range(8):
        ja, jb = _operands(12, 40, 24, seed=seed, dtype=dtype)
        out = np.asarray((ja.astype(jnp.float32) @ jb.astype(jnp.float32)).astype(ja.dtype))
        if seed % 2:
            row = seed % 12
            col = int(np.argmax(np.abs(out[row].astype(np.float32))))
            bits = np.float32(out[row, col]).view(np.uint32) ^ np.uint32(1 << (24 + seed % 5))
            out = np.array(out)
            out[row, col] = bits.view(np.float32).astype(out.dtype)
        want = bool(jabft.mm_check(ja, jb, jnp.asarray(out)))
        got = bool(abft.mm_check(_to_torch(ja), _to_torch(jb), _to_torch(out)))
        assert got == want == bool(seed % 2)


# ------------------------------------------------------- calibration --
# the port kernel's tiles (BM x BN, K steps of 32) and ragged variants:
# the checksum's row-block granularity must calibrate at each
PORT_SHAPES = [(16, 128, 64), (9, 70, 96), (128, 128, 64), (100, 130, 96)]


def _mk(rng, shape, dtype):
    m, n, k = shape
    a = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32)).to(dtype)
    return a, b


@pytest.mark.sdc
def test_checksum_zero_false_positives_200_clean_matmuls():
    """Ported from tests/test_sdc.py: the calibrated tolerance never flags
    a clean product, over 200 seeded products cycling the port's tile
    shapes and both serve dtypes."""
    for i in range(200):
        shape = PORT_SHAPES[i % len(PORT_SHAPES)]
        dtype = torch.bfloat16 if i % 2 else torch.float32
        a, b = _mk(np.random.default_rng(10_000 + i), shape, dtype)
        out, bad = tops.matmul_abft(a, b)
        assert not bool(bad), f"false positive: seed={10_000 + i} shape={shape} {dtype}"
        assert out.dtype == dtype and out.shape == (shape[0], shape[1])


@pytest.mark.sdc
def test_checksum_catches_injected_bit_flips():
    """Ported from tests/test_sdc.py: single-bit flips on a row's largest
    element, fp32 bits 20..30 and bf16-surviving bits 23..29, are all
    caught."""
    missed = []
    for i in range(60):
        shape = PORT_SHAPES[i % len(PORT_SHAPES)]
        dtype = torch.bfloat16 if i % 2 else torch.float32
        bits = range(23, 30) if dtype == torch.bfloat16 else range(20, 31)
        rng = np.random.default_rng(20_000 + i)
        a, b = _mk(rng, shape, dtype)
        out = (a.float() @ b.float()).to(dtype)
        row = int(rng.integers(out.shape[0]))
        bit = int(rng.choice(list(bits)))
        fault = np.array([abft.FAULT_MATMUL, 0, row, -1, bit, -1, 0, 0], np.int32)
        abft._maybe_flip(out, fault, abft.FAULT_MATMUL, 0, True)
        if not bool(abft.mm_check(a, b, out)):
            missed.append((20_000 + i, shape, str(dtype), bit))
    assert not missed, f"undetected injected flips: {missed}"


# ------------------------------------------------------------ the trace --
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("trans_b", [False, True])
def test_trace_mm_matches_reference(impl, trans_b):
    """``AbftTrace.mm`` against the reference's on the same fp32 operands
    and static column stats: the same product (to fp32 order), the same
    flip, the same verdict; clean, and with the fault aimed at it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.1).astype(np.float32)
    jstats = jabft.weight_colstats({"w": jnp.asarray(w)})
    tw = torch.from_numpy(np.ascontiguousarray(w.T) if trans_b else w)
    tstats = abft.weight_colstats({"w": tw})
    for armed in (False, True):
        fault = np.array([abft.FAULT_MATMUL, 1, 4, -1, 28, -1, 0, 0], np.int32)
        if not armed:
            fault[0] = abft.FAULT_NONE
        jt = jabft.AbftTrace("checksum", jnp.asarray(fault), jstats)
        tt = abft.AbftTrace("checksum", fault, tstats)
        for _ in range(2):  # call 1 is the one the fault aims at
            want = jt.mm(jnp.asarray(x), jnp.asarray(w))
            got = tt.mm(torch.from_numpy(x), tw, impl, trans_b=trans_b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        assert bool(tt.any_bad()) == bool(jt.any_bad()) == armed
        assert tt.mm_calls == jt.mm_calls == 2


def test_trace_fingerprints_paged_attention():
    """A clean paged attention output passes the sampled fingerprint; a
    flip in a sampled row fails it; a flip outside the sample in
    "checksum" mode is not seen, and "paranoid" sees it."""
    from repro_torch.kernels.flash_attention.ops import decode_attention_paged

    rng = np.random.default_rng(0)
    B, KV, G, d, bs, n_blk = 8, 2, 3, 16, 4, 4
    q = torch.from_numpy(rng.standard_normal((B, KV, G, d)).astype(np.float32))
    kpool = torch.from_numpy(rng.standard_normal((B * n_blk + 1, bs, KV, d)).astype(np.float32))
    vpool = torch.from_numpy(rng.standard_normal(kpool.shape).astype(np.float32))
    tables = (torch.randperm(B * n_blk, generator=torch.Generator().manual_seed(0)) + 1)
    tables = tables.reshape(B, n_blk).to(torch.int32)
    lengths = torch.tensor([1, 3, 4, 5, 9, 12, 16, 7], dtype=torch.int32)
    ctx = decode_attention_paged(q, kpool, vpool, tables, lengths, impl="plain")
    assert abft.sample_rows(B, "checksum") == [0, 2, 4, 6]
    for mode, row, caught in (("checksum", None, False), ("checksum", 2, True),
                              ("checksum", 3, False), ("paranoid", 3, True)):
        fault = abft.no_fault()
        if row is not None:
            fault[:6] = [abft.FAULT_ATTENTION, 0, row, -1, 29, -1]
        tr = abft.AbftTrace(mode, fault, live_splits=n_blk)
        out = tr.check_paged_attention(ctx.clone(), q, kpool, vpool, tables, lengths)
        assert bool(tr.any_bad()) == caught, (mode, row)
        assert torch.equal(out, ctx) == (row is None)
