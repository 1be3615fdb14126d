"""Port parity: the rest of the paper's analytic core.

``repro_torch.core``'s simulator, Halide-style front end, frontier
enumeration and hierarchy sweeps, the blocking search's ``table`` and
``max_evals``, the optimizer, the resource-allocation DSE and the network
tables must give the reference's ``repro.core`` results bit for bit on the
same inputs (numpy-seeded where they are random).  Both packages are
numpy-only here, so results are compared with ``==``.
"""

import importlib
import math

import numpy as np
import pytest

from repro.core import blocking as rblk
from repro.core import costmodel as rcm
from repro.core import dataflow as rdf
from repro.core import dse as rdse
from repro.core import energy as ren
from repro.core import halide as rhal
from repro.core import loopnest as rln
from repro.core import networks as rnet
from repro.core import optimizer as ropt
from repro.core import reuse as rreuse
from repro.core import schedule as rsch
from repro_torch.core import blocking as tblk
from repro_torch.core import costmodel as tcm
from repro_torch.core import dataflow as tdf
from repro_torch.core import dse as tdse
from repro_torch.core import energy as ten
from repro_torch.core import halide as thal
from repro_torch.core import loopnest as tln
from repro_torch.core import networks as tnet
from repro_torch.core import optimizer as topt
from repro_torch.core import reuse as treuse
from repro_torch.core import schedule as tsch

# the packages' ``simulate`` attribute is the function, not the module
rsim = importlib.import_module("repro.core.simulate")
tsim = importlib.import_module("repro_torch.core.simulate")

REF = dict(ln=rln, sch=rsch, df=rdf, blk=rblk, cm=rcm, en=ren, sim=rsim, hal=rhal,
           net=rnet, opt=ropt, dse=rdse, reuse=rreuse)
PORT = dict(ln=tln, sch=tsch, df=tdf, blk=tblk, cm=tcm, en=ten, sim=tsim, hal=thal,
            net=tnet, opt=topt, dse=tdse, reuse=treuse)
BOTH = (PORT, REF)


def _access_view(a):
    return ([dict(x) for x in a.reads], [dict(x) for x in a.writes], dict(a.hops), a.macs,
            a.utilization)


def _report_view(r):
    s = r.schedule
    return (r.energy_pj, dict(r.breakdown_pj), r.cycles, r.utilization,
            _access_view(r.access), dict(s.tiling), s.order, s.spatial)


def _split(n: int, parts: int, rng) -> list[int]:
    """``n`` as a product of ``parts`` factors (a random divisor chain)."""
    out = []
    for _ in range(parts - 1):
        divs = [d for d in range(1, n + 1) if n % d == 0]
        f = int(rng.choice(divs))
        out.append(f)
        n //= f
    return out + [n]


def _random_spec(rng, big: bool = False) -> dict:
    """A random temporal schedule, as plain data both packages can build."""
    if big:  # a matmul whose iteration count needs big ints
        bounds = dict(M=2**22, N=2**22, K=2**22)
        kind = "matmul"
    elif rng.random() < 0.5:
        bounds = dict(B=int(rng.integers(1, 3)), K=int(rng.choice([2, 4, 6])),
                      C=int(rng.choice([2, 3, 4])), X=int(rng.integers(2, 5)),
                      Y=int(rng.integers(1, 4)), FX=int(rng.choice([1, 3])),
                      FY=int(rng.choice([1, 3])))
        kind = "conv"
    else:
        bounds = dict(M=int(rng.choice([2, 4, 6, 8])), N=int(rng.choice([2, 3, 8])),
                      K=int(rng.choice([2, 4, 12])))
        kind = "matmul"
    L = int(rng.integers(2, 4))
    dims = list(bounds)
    tiling = {d: tuple(_split(b, L, rng)) for d, b in bounds.items()}
    order = tuple(tuple(str(d) for d in rng.permutation(dims)) for _ in range(L))
    return dict(kind=kind, bounds=bounds, tiling=tiling, order=order, L=L)


def _build(pkg, spec):
    ln, sch = pkg["ln"], pkg["sch"]
    b = spec["bounds"]
    if spec["kind"] == "conv":
        nest = ln.conv_nest("c", **b)
    else:
        nest = ln.matmul_nest("m", **b)
    caps = [512, 64 * 1024, None][-spec["L"]:]
    levels = tuple(sch.MemLevel(f"L{i}", capacity_bytes=c, double_buffered=bool(i))
                   for i, c in enumerate(caps))
    return sch.Schedule(nest=nest, levels=levels, tiling=dict(spec["tiling"]),
                        order=spec["order"], array=sch.ArraySpec(dims=(1,)),
                        spatial=((),))


@pytest.mark.parametrize("seed", range(4))
def test_simulate_matches_the_reference_on_random_schedules(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        spec = _random_spec(rng)
        got = [_access_view(p["sim"].simulate(_build(p, spec), engine=e))
               for p in BOTH for e in ("vector", "scalar")]
        assert got[0] == got[1] == got[2] == got[3], spec
        # the analytical model agrees with the exact simulator (paper Fig 7)
        sched = _build(PORT, spec)
        assert treuse.analyze(sched).reads == tsim.simulate(sched).reads, spec


def test_simulate_big_int_path_matches_the_reference():
    rng = np.random.default_rng(7)
    spec = _random_spec(rng, big=True)
    sched = _build(PORT, spec)
    assert math.prod(sched.padded_bound(d) for d in sched.nest.dims) >= tsim._INT64_SAFE_ITERS
    assert _access_view(tsim.simulate(sched)) == _access_view(rsim.simulate(_build(REF, spec)))


def _halide_view(s):
    return ([(lv.name, lv.capacity_bytes, lv.double_buffered, lv.per_pe) for lv in s.levels],
            dict(s.tiling), s.order, s.array.dims, s.spatial)


def test_halide_front_end_matches_the_reference():
    out = []
    for p in BOTH:
        nest = p["ln"].conv_nest("conv3", B=4, K=32, C=16, X=13, Y=13, FX=3, FY=3)
        s = p["hal"].listing1_example(nest)
        custom = (p["hal"].HalideSchedule(nest, array_dims=(4, 2))
                  .store("RF", 64, per_pe=True, double_buffered=False)
                  .split("FX", 3).reorder("FX", "C")
                  .store("BUF", 32 * 1024).split("C", 4).split("K", 8)
                  .store("DRAM", None).split("B", 2)
                  .at_level("BUF").reorder("K", "C", "X")
                  .unroll("K", 4, axis=0).unroll("Y", 2, axis=1)
                  .accelerate())
        out.append([(_halide_view(x), _access_view(p["reuse"].analyze(x)),
                     p["en"].evaluate(x).energy_pj) for x in (s, custom)])
    assert out[0] == out[1]


def test_enumerate_frontier_and_evaluate_hierarchies_match_the_reference():
    out = []
    for p in BOTH:
        nest = p["net"].dse_mlp()[1]
        array = p["sch"].ArraySpec(dims=(16, 16))
        flow = p["opt"].ck_dataflow(nest, array)
        hws = p["opt"].candidate_hierarchies(array)[:6]
        levels = p["dse"]._family_levels(hws)
        til, odr = p["blk"].enumerate_frontier(nest, levels, array, flow,
                                               max_choices_per_level=12, max_frontier=2048)
        cm = p["cm"].BatchedCostModel(nest, levels, array=array, spatial=flow.assigns,
                                      table=p["en"].CostTable.for_levels(levels))
        tables = [p["en"].CostTable.for_levels(h.levels()) for h in hws]
        rep = cm.evaluate_hierarchies(til, odr, tables)
        rep4 = cm.evaluate_hierarchies(np.stack([til[:64]] * 2), np.stack([odr[:64]] * 2),
                                       tables[:2])
        out.append((til.tolist(), odr.tolist(), rep.energy_pj.tolist(), rep.cycles.tolist(),
                    rep.level_totals.tolist(), rep.footprint_words.tolist(),
                    rep.utilization.tolist(), rep4.energy_pj.tolist(),
                    rep4.footprint_words.tolist()))
        # the ABFT surcharge prices a matmul nest's row blocks
        mm = p["ln"].matmul_nest("mm", M=64, N=96, K=128)
        mm_levels = (p["sch"].MemLevel("VMEM", 64 * 1024), p["sch"].MemLevel("HBM", None))
        flat = p["df"].Dataflow(assigns=((),))
        mtil, _ = p["blk"].enumerate_frontier(mm, mm_levels, p["sch"].ArraySpec(dims=(1,)),
                                              flat, max_choices_per_level=16)
        mcm = p["cm"].BatchedCostModel(mm, mm_levels, table=p["en"].CostTable.for_levels(
            mm_levels))
        out[-1] += (mtil.tolist(), mcm.abft_energy_pj(mtil).tolist())
    assert out[0] == out[1]
    assert len(out[0][0]) > 100 and len(out[0][-2]) > 10


def test_search_blocking_table_and_max_evals_match_the_reference():
    out = []
    for p in BOTH:
        sch = p["sch"]
        nest = p["ln"].conv_nest("c", B=4, K=64, C=32, X=14, Y=14, FX=3, FY=3)
        levels = (sch.MemLevel("RF", capacity_bytes=128, per_pe=True, double_buffered=False),
                  sch.MemLevel("BUF", capacity_bytes=64 * 1024),
                  sch.MemLevel("DRAM", capacity_bytes=None))
        array = sch.ArraySpec(dims=(8, 8))
        flow = p["df"].make_dataflow(nest, array, ("C", "K"))
        table = p["en"].CostTable.for_levels(
            (levels[0], sch.MemLevel("BUF", capacity_bytes=256 * 1024), levels[2]))
        for kw in (dict(table=table), dict(max_evals=60), dict(table=table, max_evals=200)):
            res = p["blk"].search_blocking(nest, levels, array, flow, beam=6, **kw)
            out.append((_report_view(res.best), res.evaluated))
        out.append(_report_view(p["blk"].optimize_orders(res.best.schedule)))
    n = len(out) // 2
    assert out[:n] == out[n:]


@pytest.mark.parametrize("net", ["alexnet", "mlp_m"])
def test_optimizer_matches_the_reference(net):
    out = []
    for p in BOTH:
        p["opt"].clear_search_cache()
        layers = p["net"].PAPER_BENCHMARKS[net]()
        res = p["opt"].evaluate_network(layers, p["opt"].eyeriss_like(), 120)
        one = p["opt"].optimize_layer(layers[-1], p["opt"].tpu_like(), max_evals=80)
        out.append(([(lr.dataflow.label(), _report_view(lr.report)) for lr in res.layers],
                    res.total_energy_pj, res.total_cycles, res.tops_per_watt(),
                    _report_view(one.report)))
    assert out[0] == out[1]


def test_candidate_hierarchies_and_dataflows_match_the_reference():
    out = []
    for p in BOTH:
        array = p["sch"].ArraySpec(dims=(16, 16))
        hws = [h for two in (False, True) for h in p["opt"].candidate_hierarchies(array, two)]
        nest = p["net"].alexnet_conv3()
        flows = p["df"].enumerate_dataflows(nest, p["sch"].ArraySpec(dims=(8, 4)))
        out.append(([(h.name, h.rf_bytes, h.buffer_bytes, h.array.dims, h.levels()) for h in hws],
                    [(f.assigns, f.label()) for f in flows],
                    p["opt"].ck_dataflow(p["net"].mobilenet()[1], array).assigns))
    assert [x[:4] for x in out[0][0]] == [x[:4] for x in out[1][0]]
    assert [[(lv.name, lv.capacity_bytes, lv.per_pe) for lv in x[4]] for x in out[0][0]] == \
        [[(lv.name, lv.capacity_bytes, lv.per_pe) for lv in x[4]] for x in out[1][0]]
    assert out[0][1:] == out[1][1:]
    assert len(out[0][0]) > 30 and len(out[0][1]) >= 20


def _points_view(points):
    return [(pt.hw.name, pt.energy_pj, pt.cycles, pt.edp) for pt in points]


def _sweep(p, path, **kw):
    array = p["sch"].ArraySpec(dims=(16, 16))
    layers = p["net"].DSE_SUITE["mlp"](batch=8)
    return p["dse"].sweep_allocations(layers, array, two_level_rf=True, max_choices_per_level=8,
                                      max_frontier=512, cache=path, **kw)


def test_dse_sweep_frontier_and_iso_throughput_match_the_reference(tmp_path):
    out = []
    for i, p in enumerate(BOTH):
        path = str(tmp_path / f"sweep{i}.json")
        pts = _sweep(p, path)
        again = _sweep(p, path)  # every block from the cache
        front = p["dse"].pareto_prune(pts)
        base = pts[0]
        best = p["dse"].best_at_iso_throughput(pts, base)
        with pytest.raises(ValueError, match="nearest miss") as err:
            p["dse"].best_at_iso_throughput(pts, base, slack=1e-6)
        out.append((_points_view(pts), _points_view(again), _points_view(front),
                     _points_view([best]), str(err.value)))
    assert out[0] == out[1]
    assert len(out[0][0]) > 10 and 0 < len(out[0][2]) < len(out[0][0])


def test_dse_sweep_with_two_workers_matches_the_reference(tmp_path):
    got = _sweep(PORT, str(tmp_path / "pool.json"), workers=2)
    want = _sweep(REF, None)
    assert _points_view(got) == _points_view(want)


def test_network_tables_match_the_reference():
    for name in sorted(rnet.PAPER_BENCHMARKS):
        got = [(n.name, dict(n.bounds), n.key()) for n in tnet.PAPER_BENCHMARKS[name]()]
        want = [(n.name, dict(n.bounds), n.key()) for n in rnet.PAPER_BENCHMARKS[name]()]
        assert got == want, name
    for name in sorted(rnet.DSE_SUITE):
        assert [n.key() for n in tnet.DSE_SUITE[name]()] == [
            n.key() for n in rnet.DSE_SUITE[name]()], name
    assert tnet.alexnet_conv3().key() == rnet.alexnet_conv3().key()
    assert tnet.googlenet_4c3r().key() == rnet.googlenet_4c3r().key()
    assert sorted(tnet.PAPER_BENCHMARKS) == sorted(rnet.PAPER_BENCHMARKS)


def test_flat_schedule_and_describe_match_the_reference():
    out = []
    for p in BOTH:
        nest = p["ln"].depthwise_nest("dw", B=2, C=8, X=7, Y=7, FX=3, FY=3, stride=2)
        sch = p["sch"]
        s = sch.flat_schedule(nest, (sch.MemLevel("BUF", 4096), sch.MemLevel("DRAM", None)),
                              array=sch.ArraySpec(dims=(4,)), spatial=[[("K", 4)]])
        cm = p["cm"].BatchedCostModel(nest, s.levels, array=s.array, spatial=s.spatial)
        til, odr = cm.pack([s, s])
        out.append((_halide_view(s), s.describe(), s.as_arrays(), til.tolist(), odr.tolist(),
                    cm.evaluate(til, odr).energy_pj.tolist(),
                    _access_view(p["reuse"].analyze(s))))
    assert out[0] == out[1]
