"""Port parity: gradients through the two kernels that training reaches,
``ops.linear_scan`` (recurrentgemma) and ``ops.wkv6`` (rwkv6), against
``jax.grad`` of the reference's plain recurrences (``linear_scan_ref``,
``wkv6_ref``).

On the CPU the wrappers run their plain versions, the same code path the
card runs with the kernels: the ``autograd.Function``, the scan's
reverse-time adjoint through ``ops.linear_scan`` itself, WKV-6's
recomputed plain backward.  Upstream gradients are seeded numpy draws on
both outputs (the sequence and the final state).  Tolerance: 1e-5 of each
gradient's scale (fp32; the two frameworks sum in other orders).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.linear_scan import ref as jref  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan as ls  # noqa: E402
from repro_torch.kernels.linear_scan import ops  # noqa: E402


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("B,T,D", [(2, 1, 5), (2, 9, 16), (1, 33, 8)])
def test_linear_scan_gradients_match_reference(B, T, D):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (B, T, D)).astype(np.float32)
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, D)).astype(np.float32)
    g_out = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    g_h = rng.normal(0, 1, (B, D)).astype(np.float32)

    def jloss(a, x, h0):
        out, hT = jref.linear_scan_ref(a, x, h0)
        return jnp.sum(out * g_out) + jnp.sum(hT * g_h)

    want = jax.grad(jloss, argnums=(0, 1, 2))(a, x, h0)
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, x, h0)]
    out, hT = ops.linear_scan(*ts)
    want_out, _ = jref.linear_scan_ref(a, x, h0)
    _close(out, want_out)
    got = torch.autograd.grad((out, hT), ts, (torch.from_numpy(g_out), torch.from_numpy(g_h)))
    for g, w in zip(got, want):
        _close(g, w)


def test_wkv6_gradients_match_reference():
    B, H, T, D = 2, 2, 7, 16
    rng = np.random.default_rng(5)
    r, k, v = (rng.normal(0, 1, (B, H, T, D)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.3, 0.99, (B, H, T, D)).astype(np.float32)
    u = rng.normal(0, 0.5, (H, D)).astype(np.float32)
    s0 = rng.normal(0, 1, (B, H, D, D)).astype(np.float32)
    g_out = rng.normal(0, 1, (B, H, T, D)).astype(np.float32)
    g_s = rng.normal(0, 1, (B, H, D, D)).astype(np.float32)

    def jloss(*args):
        out, sT = jref.wkv6_ref(*args)
        return jnp.sum(out * g_out) + jnp.sum(sT * g_s)

    want = jax.grad(jloss, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    ts = [torch.from_numpy(t).requires_grad_() for t in (r, k, v, w, u, s0)]
    out, sT = ops.wkv6(*ts)
    got = torch.autograd.grad((out, sT), ts, (torch.from_numpy(g_out), torch.from_numpy(g_s)))
    for g, w_ in zip(got, want):
        _close(g, w_)


def test_only_the_inputs_that_require_grad_get_one():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1, (1, 4, 3)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 3)).astype(np.float32))
    h0 = torch.zeros(1, 3)
    out, _ = ops.linear_scan(a, x, h0)
    (ga,) = torch.autograd.grad(out.sum(), [a])
    assert ga.shape == a.shape and torch.isfinite(ga).all()
    with torch.no_grad():  # no graph: the wrapper is called directly
        out2, _ = ops.linear_scan(a, x, h0)
    assert not out2.requires_grad and torch.equal(out2, out.detach())


def test_inplace_under_autograd_raises():
    a = torch.rand(1, 2, 3, requires_grad=True)
    with pytest.raises(ValueError, match="inplace"):
        ops.linear_scan(a, torch.rand(1, 2, 3), torch.zeros(1, 3), inplace=True)
    r = torch.rand(1, 1, 2, 16, requires_grad=True)
    z = torch.rand(1, 1, 2, 16)
    with pytest.raises(ValueError, match="inplace"):
        ops.wkv6(r, z, z, z, torch.rand(1, 16), torch.zeros(1, 1, 16, 16), inplace=True)
    # no input requires grad: the serve path's in-place update still works
    h0 = torch.zeros(1, 3)
    ops.linear_scan(torch.rand(1, 2, 3), torch.rand(1, 2, 3), h0, inplace=True)
    assert h0.abs().sum() > 0


def test_cpu_gradients_launch_no_kernel():
    before = (ls.linear_scan_cuda.launches, ls.wkv6_cuda.launches)
    a = torch.rand(1, 3, 2, requires_grad=True)
    out, _ = ops.linear_scan(a, torch.rand(1, 3, 2), torch.zeros(1, 2))
    out.sum().backward()
    assert (ls.linear_scan_cuda.launches, ls.wkv6_cuda.launches) == before
