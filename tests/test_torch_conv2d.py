"""Port parity: the paper's CONV nest (``kernels/conv2d``).

The same numpy inputs (seeded) go through the reference's
``repro.kernels.conv2d.ops.conv2d`` (its Pallas kernel in interpret mode,
with the tiles its TPU search picks) and the port's ``ops.conv2d`` (the
plain version on the CPU, with the tiles the port's search picks for the
H100).  Tolerances are the reference test's own
(``tests/test_kernels.py:21-24``): 2e-4 in fp32 (summation order and the C
blocking differ), 2e-2 in bf16 (a few bf16 ulps on outputs of order 10).
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.conv2d import ops as jops  # noqa: E402
from repro.kernels.conv2d.ref import conv2d_ref as jref  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.core import networks  # noqa: E402
from repro_torch.kernels.conv2d import conv2d as tconv  # noqa: E402
from repro_torch.kernels.conv2d import ops as tops  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref as tref  # noqa: E402


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _no_tile_caches(monkeypatch):
    monkeypatch.setenv("REPRO_TILE_CACHE", "")
    monkeypatch.setenv("REPRO_TORCH_TILE_CACHE", "")


def _pair(a, dtype):
    """One numpy array as a (jax, torch) pair of ``dtype`` with identical
    bits (bf16 rounds once, in jax)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _inputs(B, H, W, C, K, FX, FY, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C), np.float32),
            rng.standard_normal((FX, FY, C, K), np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(  # the shapes of tests/test_kernels.py:67-79
    "B,H,C,K,F", [(1, 8, 8, 16, 3), (2, 13, 16, 8, 3), (1, 6, 4, 4, 1), (2, 10, 3, 5, 5)]
)
def test_conv2d_matches_reference(B, H, C, K, F, dtype):
    x, w = _inputs(B, H + F - 1, H + F - 1, C, K, F, F, seed=B * H + C)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    want = jops.conv2d(jx, jw)
    got = tops.conv2d(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (B, H, H, K)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref(jx, jw)), **_tol(dtype))


@pytest.mark.parametrize("shape", [(1, 11, 11, 4, 8, 3), (2, 15, 13, 3, 6, 5)])
def test_conv2d_strided_routes_like_the_reference(shape):
    B, H, W, C, K, F = shape
    x, w = _inputs(B, H, W, C, K, F, F, seed=H)
    tconv.conv2d_cuda.launches = 0
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert tconv.conv2d_cuda.launches == 0


def _layer(net, name):
    return next(n for n in getattr(networks, net)(16) if n.name == name).bounds


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("net,name,X,C,K", [
    ("alexnet", "conv2", 7, 24, 32),      # 5x5
    ("vgg16", "conv1", 10, 3, 16),        # C = 3
    ("googlenet", "4c_1x1", 5, 48, 24),   # 1x1
])
def test_cnn_layers_narrowed_match_reference(net, name, X, C, K, dtype):
    """One layer of each of the paper's CNNs, its filter kept and its
    channels and spatial size cut, through both entry points."""
    b = _layer(net, name)
    FX, FY = b["FX"], b["FY"]
    assert C <= b["C"] and K <= b["K"] and X <= b["X"]
    x, w = _inputs(2, X + FX - 1, X + FY - 1, C, K, FX, FY, seed=X + C + K)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    np.testing.assert_allclose(_np(tops.conv2d(tx, tw)), _np(jops.conv2d(jx, jw)),
                               **_tol(dtype))


@pytest.mark.parametrize("FX,FY", [(3, 1), (1, 3), (3, 2), (5, 3)])
def test_non_square_filters_against_the_oracle(FX, FY):
    """Held against the port's own oracle only: the reference kernel walks
    w[fy, fx] over range(FY) x range(FX) on an (FX, FY, ...) array, which
    fails on a non-square filter (and every layer of the paper is square).
    The port computes what both oracles compute: HWIO, the first filter axis
    walking H."""
    x, w = _inputs(2, 9, 8, 20, 12, FX, FY, seed=FX * 10 + FY)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tops.conv2d(tx, tw)
    assert got.shape == (2, 9 - FX + 1, 8 - FY + 1, 12)
    torch.testing.assert_close(got, tref(tx, tw), rtol=2e-5, atol=2e-5)


def test_plain_version_blocks_c_and_the_wrapper_takes_it_on_the_cpu():
    """Several C blocks, a ragged last one: the plain version equals the
    oracle, and the wrapper returns the plain version for CPU tensors."""
    x, w = _inputs(2, 7, 9, 40, 24, 3, 3, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tiles = tconv.ConvTiles(bx=2, by=3, bc=16, bk=16)
    got = tconv.conv2d_plain(tx, tw, tiles)
    torch.testing.assert_close(got, tref(tx, tw), rtol=2e-5, atol=2e-5)
    assert torch.equal(tconv.conv2d_cuda(tx, tw, tiles), got)


def test_wrappers_reject_other_devices():
    """Neither the wrapper nor the entry point falls back to the plain
    version for a tensor that is neither on the CPU nor on the card."""
    x = torch.zeros((1, 5, 5, 16), device="meta", dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tconv.conv2d_cuda(x, w, tconv.ConvTiles(3, 3, 16, 16))
    with pytest.raises(ValueError):
        tops.conv2d(x, w)


def _stride1_layers():
    out = {}
    for net in ("alexnet", "vgg16", "googlenet"):
        for n in getattr(networks, net)(16):
            b = n.bounds
            if b["X"] > 1 and n.tensor("I").coupled["X"][1] == 1:
                out.setdefault((b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"]),
                               f"{net}/{n.name}")
    return out


@pytest.mark.parametrize("shape", list(_stride1_layers()), ids=list(_stride1_layers().values()))
def test_hopper_tiles_of_every_cnn_layer_fit_the_kernel(shape):
    """The tile the search picks on the H100's hierarchy, at the layer's
    full size, is one the kernel takes: bc and bk multiples of the MMA
    alignment, within shared memory's budget and the block's accumulator
    tiles, and no side past its extent (rounded up to the alignment)."""
    X, Y, C, K, FX, FY = shape
    t = tops.choose_conv_blocks(16, X, Y, C, K, FX, FY)
    assert t.bc % hw.MMA_ALIGN == 0 and t.bk % hw.MMA_ALIGN == 0
    assert t.bc <= -(-C // 16) * 16 and t.bk <= -(-K // 16) * 16
    assert 1 <= t.bx <= X and 1 <= t.by <= Y
    assert t.smem_bytes(FX, FY) <= hw.SMEM_BUDGET_BYTES
    assert t.warp_tiles() <= tconv.MAX_WARP_TILES
    assert 2 * (t.smem_bytes(FX, FY) + hw.SMEM_RESERVED_PER_BLOCK_BYTES) <= hw.SMEM_PER_SM_BYTES
