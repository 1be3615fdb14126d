"""Port parity: the WKV-6 recurrence (``kernels/linear_scan``).

The same seeded numpy inputs go through the reference's
``repro.kernels.linear_scan.ops.wkv6`` (its Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it), its ``ref.wkv6_ref``, and the
port's ``wkv6_plain`` and ``ops.wkv6`` (the plain version on the CPU).
Tolerance: the reference test's own, rtol = atol = 2e-4 (fp32 sums in
other orders).  The model path's ``wkv_scan`` (the reference's chunked
scan, the port's one call of ``ops.wkv6`` on transposed views) is held at
lengths that are not a multiple of the reference's chunk.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import rwkv as jrwkv  # noqa: E402
from repro.kernels.linear_scan import ops as jops  # noqa: E402
from repro.kernels.linear_scan.ref import wkv6_ref as jref  # noqa: E402
from repro_torch.arch import rwkv as trwkv  # noqa: E402
from repro_torch.kernels.linear_scan import ops as tops  # noqa: E402
from repro_torch.kernels.linear_scan.linear_scan import wkv6_cuda, wkv6_plain  # noqa: E402
from repro_torch.kernels.linear_scan.ref import wkv6_ref as tref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, H, T, D, seed, s0_scale):
    """r, k, v ~ N(0, 1), a decay w in (0, 1) that varies per step and
    channel, u ~ N(0, 1), s0 ~ s0_scale * N(0, 1); (B, H, T, D) layout."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in "rkv")
    w = np.exp(-np.exp(rng.normal(-1.0, 1.0, (B, H, T, D)))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = (s0_scale * rng.standard_normal((B, H, D, D))).astype(np.float32)
    return r, k, v, w, u, s0


SHAPES = [(1, 1, 8, 16), (2, 3, 17, 8), (1, 2, 40, 64), (2, 2, 5, 64)]


@pytest.mark.parametrize("s0_scale", [0.0, 1.0])
@pytest.mark.parametrize("B,H,T,D", SHAPES)
def test_wkv6_plain_matches_reference_kernel_and_ref(B, H, T, D, s0_scale):
    args = _inputs(B, H, T, D, seed=B * 100 + T, s0_scale=s0_scale)
    j_out, j_s = jops.wkv6(*map(jnp.asarray, args), interpret=True)
    r_out, r_s = jref(*map(jnp.asarray, args))
    t_out, t_s = wkv6_plain(*map(torch.from_numpy, args))
    e_out, e_s = tops.wkv6(*map(torch.from_numpy, args))
    for want_out, want_s in ((j_out, j_s), (r_out, r_s)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(t_s.numpy(), np.asarray(want_s), **TOL)
    # the entry point on CPU tensors is the plain version, bit for bit
    assert torch.equal(e_out, t_out) and torch.equal(e_s, t_s)


def test_inplace_writes_the_final_state_into_s0():
    args = [torch.from_numpy(a) for a in _inputs(2, 2, 9, 16, seed=3, s0_scale=1.0)]
    want_out, want_s = tref(*args)
    s0 = args[5].clone()
    out, sT = tops.wkv6(*args[:5], s0, inplace=True)
    assert sT is s0
    assert torch.equal(out, want_out) and torch.equal(s0, want_s)


@pytest.mark.parametrize("T", [1, 40, 70])
def test_port_wkv_scan_matches_reference_wkv_scan(T):
    """(B, T, H, D) streams; the reference pads T to its 64-step chunks."""
    B, H, D = 2, 3, 16
    r, k, v, w, u, s0 = _inputs(B, H, T, D, seed=T, s0_scale=1.0)
    bthd = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)]
    j_out, j_s = jrwkv.wkv_scan(*map(jnp.asarray, bthd), jnp.asarray(u), jnp.asarray(s0))
    t_out, t_s = trwkv.wkv_scan(*map(torch.from_numpy, bthd), torch.from_numpy(u),
                                torch.from_numpy(s0))
    assert t_out.shape == (B, T, H, D)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 4, 64, seed=9, s0_scale=1.0)]
    before = wkv6_cuda.launches
    out, sT = wkv6_cuda(*args)
    assert wkv6_cuda.launches == before
    want_out, want_s = wkv6_plain(*args)
    assert torch.equal(out, want_out) and torch.equal(sT, want_s)


def test_wrappers_reject_other_devices():
    """Neither the wrapper nor the entry point falls back to the plain
    version for a tensor that is neither on the CPU nor on the card."""
    B, H, T, D = 1, 2, 3, 64
    streams = [torch.zeros((B, H, T, D), device="meta") for _ in range(4)]
    u = torch.zeros((H, D), device="meta")
    s0 = torch.zeros((B, H, D, D), device="meta")
    with pytest.raises(ValueError):
        wkv6_cuda(*streams, u, s0)
    with pytest.raises(ValueError):
        tops.wkv6(*streams, u, s0)
