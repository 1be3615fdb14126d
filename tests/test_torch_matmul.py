"""Port parity: the GEMM kernel's plain version against the reference's
``matmul_pallas`` (interpret mode) and ``matmul_ref``.

Ragged shapes (not multiples of any tile) and a transposed B, the layout
of the tied unembedding.  Tolerances: fp32 to 1e-5 relative (summation
order); bf16 outputs to one bf16 ulp of the output scale (both sides
accumulate in fp32 and round once at the store).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.matmul.matmul import matmul_pallas  # noqa: E402
from repro.kernels.matmul.ref import matmul_ref as jmatmul_ref  # noqa: E402
from repro_torch.kernels.matmul import ops as tops  # noqa: E402
from repro_torch.kernels.matmul.matmul import matmul_cuda, matmul_plain  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((M, K), np.float32),
        rng.standard_normal((K, N), np.float32),
    )


def _pallas(a, b, blocks=(8, 8, 8)):
    """The reference kernel in interpret mode, padded to its blocks as
    ``ops.matmul`` pads (the port's kernel masks instead)."""
    bm, bn, bk = blocks
    M, K = a.shape
    N = b.shape[1]
    ap = jnp.pad(a, ((0, (-M) % bm), (0, (-K) % bk)))
    bp = jnp.pad(b, ((0, (-K) % bk), (0, (-N) % bn)))
    out = matmul_pallas(ap, bp, bm=bm, bn=bn, bk=bk, interpret=True)
    return np.asarray(out[:M, :N].astype(jnp.float32))


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 24, 40), (5, 17, 9), (13, 40, 33)])
def test_plain_matches_pallas_fp32(M, K, N, trans_b):
    a, b = _operands(M, K, N, seed=M + K + N)
    want = _pallas(jnp.asarray(a), jnp.asarray(b))
    tb = torch.from_numpy(np.ascontiguousarray(b.T) if trans_b else b)
    got = tops.matmul(torch.from_numpy(a), tb, trans_b=trans_b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("trans_b", [False, True])
def test_plain_matches_pallas_bf16(trans_b):
    M, K, N = 7, 48, 24
    a, b = _operands(M, K, N, seed=3)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = _pallas(ja, jb)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(torch.bfloat16)
    got = matmul_plain(ta, tb.T.contiguous() if trans_b else tb, trans_b=trans_b)
    assert got.dtype == torch.bfloat16
    ulp = 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)
    # and the ported oracle against the reference oracle
    ref = np.asarray(jmatmul_ref(ja, jb).astype(jnp.float32))
    np.testing.assert_allclose(matmul_ref(ta, tb).float().numpy(), ref, rtol=0, atol=ulp)


def test_wrapper_rejects_mixed_and_bad_operands():
    a = torch.zeros((2, 3), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        matmul_cuda(a, a, trans_b=True)
    with pytest.raises(ValueError):
        matmul_cuda(torch.zeros(2, 3), a)
