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
    full size and the paper's batch of 16, is one the tensor-core body
    takes: at most 128 pixels a block, a 16-, 32- or 64-channel step (one
    TMA swizzle span), whole 64-column filter panels up to 256, no side
    past its extent, 2-4 ring stages within a block's shared memory, the
    accumulators and a tap's A fragments within a thread's registers.  It
    is the search's own tile (the entry point adds nothing), and the MMAs
    compute at most a third more outputs than the layer has: the
    output-tile utilization, over the whole layer with its ragged edge
    tiles, is at least 0.75."""
    X, Y, C, K, FX, FY = shape
    choice = tops.conv_search(16, X, Y, C, K, FX, FY)
    t = tops.choose_conv_blocks(16, X, Y, C, K, FX, FY)
    assert t == choice.tiles
    sch = choice.report.schedule
    assert t.rows() == sch.used_pes() // hw.CONV_PANEL <= tconv.TC_ROWS
    assert t.bc in tconv.TC_CHUNKS and t.bk % hw.CONV_PANEL == 0
    assert hw.CONV_PANEL <= t.bk <= min(hw.WGMMA_MAX_N, -(-K // 64) * 64)
    assert 1 <= t.bx <= X and 1 <= t.by <= Y and 1 <= t.nb <= 16
    assert hw.CONV_RING_STAGES[0] <= t.stages <= hw.CONV_RING_STAGES[1]
    assert t.ring_bytes(FX, FY) <= hw.SMEM_PER_BLOCK_BYTES
    assert t.data_regs() <= tconv.TC_DATA_REGS
    assert t.utilization(16, X, Y, K) >= 0.75


def test_search_sees_the_tensor_cores():
    """What the description of the H100 changes: the search's register
    tile is whole 64-column panels (the old (SMEM, HBM) pair gave K factors
    of 4-16, which the kernel padded to a warp tile of 32), small images
    share a block (batch in the array's rows), and the grid never splits C
    (the reduction stays in one block) or the filter window."""
    ch = tops.conv_search(16, 7, 7, 192, 384, 3, 3)
    sch = ch.report.schedule
    assert ch.tiles.nb > 1 and sch.spatial_factor("B") == ch.tiles.nb
    for X, C, K, F in [(56, 256, 256, 3), (14, 512, 512, 3), (13, 384, 256, 3)]:
        sch = tops.conv_search(16, X, X, C, K, F, F).report.schedule
        top = len(sch.levels) - 1
        assert sch.tiling["C"][top] == sch.tiling["FX"][top] == sch.tiling["FY"][top] == 1
        assert sch.cum_tile(1, include_spatial=True)["K"] >= hw.CONV_PANEL


def test_fp32_tiles_keep_the_cuda_core_search():
    """The fp32 body's tile comes from the (shared memory, HBM) search in
    4-byte words, rounded to 16 and fitted to its warp tiles and budget."""
    t = tops.choose_conv_blocks(16, 13, 13, 256, 384, 3, 3, word_bytes=4)
    assert t.nb == 1 and t.bc % hw.MMA_ALIGN == 0 and t.bk % hw.MMA_ALIGN == 0
    assert t.warp_tiles() <= tconv.MAX_WARP_TILES
    assert t.smem_bytes(3, 3, 4) <= hw.SMEM_BUDGET_BYTES


def test_tile_filter_none_leaves_the_search_as_it_was():
    """The core copy's optional tile filter: None (the default) and a
    filter that keeps everything give the same search."""
    from repro_torch.core.blocking import search_blocking
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.core.loopnest import conv_nest
    from repro_torch.core.schedule import ArraySpec

    nest = conv_nest("c", B=1, K=256, C=128, X=14, Y=14, FX=3, FY=3)
    args = (nest, hw.hopper_f32_levels(), ArraySpec(dims=(1,)), Dataflow(assigns=((),)))
    a = search_blocking(*args, beam=8)
    b = search_blocking(*args, beam=8, tile_filter=lambda level, f, inner: True)
    assert a.best.schedule == b.best.schedule and a.best.energy_pj == b.best.energy_pj
