"""Port parity: the diagonal linear scan (``kernels/linear_scan``, the
RG-LRU's recurrence ``h_t = a_t * h_{t-1} + x_t``).

The same seeded numpy inputs go through the reference's
``repro.kernels.linear_scan.ops.linear_scan`` (its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it), its
``ref.linear_scan_ref``, and the port's ``linear_scan_plain``,
``ref.linear_scan_ref`` and ``ops.linear_scan`` (the plain version on the
CPU).  Tolerance: the reference test's own, rtol = atol = 1e-5 (fp32; the
reference may contract the step into one fused multiply-add, the port
rounds the product and the sum).  The port's own oracle and plain version
are held bit for bit.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.linear_scan import ops as jops  # noqa: E402
from repro.kernels.linear_scan.ref import linear_scan_ref as jref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as tops  # noqa: E402
from repro_torch.kernels.linear_scan.linear_scan import (  # noqa: E402
    linear_scan_cuda,
    linear_scan_plain,
)
from repro_torch.kernels.linear_scan.ref import linear_scan_ref as tref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, D, seed):
    """a in (0, 1) (a sigmoid of N(0, 1), as the reference's test draws it),
    x and h0 ~ N(0, 1); fp32."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, D))))).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, x, h0


SHAPES = [(2, 16, 64), (2, 33, 256), (2, 128, 128), (1, 1, 2560), (3, 5, 7)]


@pytest.mark.parametrize("B,T,D", SHAPES)
def test_plain_matches_reference_kernel_and_ref(B, T, D):
    args = _inputs(B, T, D, seed=B * 1000 + T + D)
    j_out, j_h = jops.linear_scan(*map(jnp.asarray, args), interpret=True)
    r_out, r_h = jref(*map(jnp.asarray, args))
    t_out, t_h = linear_scan_plain(*map(torch.from_numpy, args))
    for want_out, want_h in ((j_out, j_h), (r_out, r_h)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(t_h.numpy(), np.asarray(want_h), **TOL)
    # the port's oracle and the entry point on CPU tensors: bit for bit
    o_out, o_h = tref(*map(torch.from_numpy, args))
    e_out, e_h = tops.linear_scan(*map(torch.from_numpy, args))
    assert torch.equal(o_out, t_out) and torch.equal(o_h, t_h)
    assert torch.equal(e_out, t_out) and torch.equal(e_h, t_h)


def test_plain_is_the_step_loop_of_a_multiply_then_an_add():
    """What the CUDA kernel computes bitwise: per step h = a*h rounded,
    then h + x rounded."""
    a, x, h0 = map(torch.from_numpy, _inputs(2, 9, 33, seed=5))
    out, hT = linear_scan_plain(a, x, h0)
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h
        h = h + x[:, t]
        assert torch.equal(out[:, t], h)
    assert torch.equal(hT, h)


def test_inplace_writes_the_final_state_into_h0():
    a, x, h0 = map(torch.from_numpy, _inputs(2, 11, 40, seed=3))
    want_out, want_h = tref(a, x, h0)
    state = h0.clone()
    out, hT = tops.linear_scan(a, x, state, inplace=True)
    assert hT is state
    assert torch.equal(out, want_out) and torch.equal(state, want_h)


def test_strided_views_and_zero_steps():
    """(B, T, D) views with a contiguous last axis (a slice of a wider
    buffer) give the contiguous result; T = 0 returns h0's values."""
    a, x, h0 = map(torch.from_numpy, _inputs(2, 6, 16, seed=4))
    wide = torch.zeros((2, 12, 16))
    wide[:, ::2] = a
    out, hT = tops.linear_scan(wide[:, ::2], x, h0)
    want_out, want_h = tref(a, x, h0)
    assert torch.equal(out, want_out) and torch.equal(hT, want_h)
    out0, h00 = tops.linear_scan(a[:, :0], x[:, :0], h0)
    assert out0.shape == (2, 0, 16) and torch.equal(h00, h0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = [torch.from_numpy(t) for t in _inputs(2, 4, 64, seed=9)]
    before = linear_scan_cuda.launches
    out, hT = linear_scan_cuda(*args)
    assert linear_scan_cuda.launches == before
    want_out, want_h = linear_scan_plain(*args)
    assert torch.equal(out, want_out) and torch.equal(hT, want_h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_reject_other_devices(dtype):
    """Neither the wrapper nor the entry point falls back to the plain
    version for a tensor that is neither on the CPU nor on the card, in any
    dtype."""
    a = torch.zeros((1, 3, 64), dtype=dtype, device="meta")
    h0 = torch.zeros((1, 64), dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        linear_scan_cuda(a, a, h0)
    with pytest.raises(ValueError):
        tops.linear_scan(a, a, h0)
