"""Port parity: the port's copy of the paper's analytic core.

``repro_torch.core`` (loop nests, schedules, reuse and energy model,
batched cost model, blocking search, TPU GEMM tile mapper, the CNN tables)
must give the reference's ``repro.core`` results bit for bit: the same best
schedule (loop orders and cumulative tiles at every level) and the same
energy report, exactly, on the same nests and hierarchies.  The kernels'
tile choices built on it must match too: ``choose_conv_blocks`` on the
reference's TPU levels returns the reference's ``(bc, bk)``, and
``choose_matmul_tiles`` the reference's tiles.  Both packages' on-disk tile
caches are off, so every answer comes from a search.
"""

import pytest

pytest.importorskip("jax")
from repro.core import blocking as rblk  # noqa: E402
from repro.core import dataflow as rdf  # noqa: E402
from repro.core import energy as ren  # noqa: E402
from repro.core import loopnest as rln  # noqa: E402
from repro.core import mapper as rmap  # noqa: E402
from repro.core import networks as rnet  # noqa: E402
from repro.core import schedule as rsch  # noqa: E402
from repro.kernels.conv2d import ops as rconv  # noqa: E402
from repro.kernels.flash_attention import ops as rfa  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.core import blocking as tblk  # noqa: E402
from repro_torch.core import dataflow as tdf  # noqa: E402
from repro_torch.core import energy as ten  # noqa: E402
from repro_torch.core import loopnest as tln  # noqa: E402
from repro_torch.core import mapper as tmap  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core import schedule as tsch  # noqa: E402
from repro_torch.kernels.conv2d import ops as tconv  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402


@pytest.fixture(autouse=True)
def _no_tile_caches(monkeypatch):
    monkeypatch.setenv("REPRO_TILE_CACHE", "")
    monkeypatch.setenv("REPRO_TORCH_TILE_CACHE", "")


def _nest(ln, net, name):
    """The same nest built by one package's constructors."""
    if name == "alexnet_conv3":
        return net.alexnet(16)[2]
    if name == "googlenet_4c_1x1":
        return next(n for n in net.googlenet(16) if n.name == "4c_1x1")
    if name == "vgg_3x3_small":  # VGG conv9's channels at 14 x 14 output
        return ln.conv_nest("conv9s", B=16, K=512, C=512, X=14, Y=14, FX=3, FY=3)
    return ln.matmul_nest("mm", M=256, N=1024, K=512)


def _hierarchy(sch, df, en, name):
    """(levels, array, dataflow) of one package for a named hierarchy."""
    if name == "tpu_vmem":  # the reference conv kernel's (VMEM, HBM) pair
        levels = (sch.MemLevel("VMEM", capacity_bytes=en.TPU_VMEM_BYTES // 8),
                  sch.MemLevel("HBM", capacity_bytes=None))
        return levels, sch.ArraySpec(dims=(1,)), df.Dataflow(assigns=((),))
    if name == "hopper_smem":
        levels = (sch.MemLevel("SMEM", capacity_bytes=hw.SMEM_BUDGET_BYTES),
                  sch.MemLevel("HBM", capacity_bytes=None))
        return levels, sch.ArraySpec(dims=(1,)), df.Dataflow(assigns=((),))
    # the paper's spatial array: per-PE RF, shared buffer, DRAM, C|K on 16x16
    levels = (sch.MemLevel("RF", capacity_bytes=64, per_pe=True, double_buffered=False),
              sch.MemLevel("BUF", capacity_bytes=64 * 1024),
              sch.MemLevel("DRAM", capacity_bytes=None))
    return (levels, sch.ArraySpec(dims=(16, 16)),
            df.Dataflow(assigns=((("C", 16),), (("K", 16),))))


def _schedule_view(s):
    return (dict(s.tiling), s.order, s.spatial,
            [s.cum_tile(lv, include_spatial=True) for lv in range(len(s.levels))])


def _report_view(r):
    a = r.access
    return (r.energy_pj, dict(r.breakdown_pj), r.cycles, r.utilization,
            [dict(x) for x in a.reads], [dict(x) for x in a.writes], dict(a.hops), a.macs)


@pytest.mark.parametrize("nest,hier", [
    (n, h) for n in ("alexnet_conv3", "googlenet_4c_1x1", "vgg_3x3_small", "matmul")
    for h in ("tpu_vmem", "hopper_smem", "paper_array")
    if not (n == "matmul" and h == "paper_array")  # C|K names CONV dims
])
def test_search_blocking_matches_the_reference(nest, hier):
    out = []
    for ln, net, sch, df, blk, en in ((tln, tnet, tsch, tdf, tblk, ten),
                                      (rln, rnet, rsch, rdf, rblk, ren)):
        levels, array, flow = _hierarchy(sch, df, en, hier)
        res = blk.search_blocking(_nest(ln, net, nest), levels, array, flow, beam=8)
        out.append((_schedule_view(res.best.schedule), _report_view(res.best), res.evaluated))
    assert out[0] == out[1]


def test_cnn_tables_match_the_reference():
    for name in ("alexnet", "vgg16", "googlenet"):
        got = [(n.name, dict(n.bounds), n.key()) for n in getattr(tnet, name)(16)]
        want = [(n.name, dict(n.bounds), n.key()) for n in getattr(rnet, name)(16)]
        assert got == want, name


def _stride1_conv_shapes():
    seen = []
    for name in ("alexnet", "vgg16", "googlenet"):
        for n in getattr(rnet, name)(16):
            b = n.bounds
            if b["X"] == 1 or n.tensor("I").coupled["X"][1] != 1:
                continue
            key = (b["X"], b["Y"], b["C"], b["K"], b["FX"], b["FY"])
            if key not in seen:
                seen.append(key)
    return seen


def test_choose_conv_blocks_on_tpu_levels_gives_the_reference_blocks():
    """On the reference's (VMEM, HBM) levels the port's tile choice rounds
    the search's C and K factors to the reference's (bc, bk) on every
    distinct stride-1 CONV layer of the paper's three CNNs."""
    levels = (tsch.MemLevel("VMEM", capacity_bytes=ten.TPU_VMEM_BYTES // 8,
                            double_buffered=True),
              tsch.MemLevel("HBM", capacity_bytes=None))
    shapes = _stride1_conv_shapes()
    assert len(shapes) == 20
    for X, Y, C, K, FX, FY in shapes:
        t = tconv.choose_conv_blocks(16, X, Y, C, K, FX, FY, levels=levels)
        assert (t.bc, t.bk) == rconv.choose_conv_blocks(16, X, Y, C, K, FX, FY), (X, C, K)


@pytest.mark.parametrize("M,N,K", [(8, 1024, 64), (8, 960, 960), (512, 512, 512),
                                   (37, 2560, 960), (4096, 14336, 4096)])
def test_choose_matmul_tiles_matches_the_reference(M, N, K):
    assert tmap.choose_matmul_tiles(M, N, K) == tmap.MatmulTiles(
        **vars(rmap.choose_matmul_tiles(M, N, K)))


def test_pick_decode_bk_matches_the_reference():
    """The unset contiguous decode split equals the reference's jnp-twin
    rule (the mapper's KV tile, capped at 64, at least 8, a divisor of S)
    at every query group and head width."""
    for S in (1, 5, 8, 12, 16, 48, 64, 96, 100, 128, 250, 256, 1000, 1024, 2048):
        for G, d in ((1, 64), (3, 64), (4, 128), (8, 64)):
            assert tfa._pick_decode_bk(S) == rfa._pick_decode_bk(S, G, d, "xla"), (S, G, d)
