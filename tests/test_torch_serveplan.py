"""Port parity and H100 pricing: the serve planner (``core/serveplan.py``).

On the reference's TPU description (``ServeHardware.tpu_v5e()``) the port's
planner must return the reference's knobs and the same predicted numbers,
bit for bit, through the same step model, calibration, knob validation and
plan cache.  On the default H100 description a step is priced from the
port's own kernels' plans: the GEMM's (``kernels/matmul/matmul.plan``) and
decode attention's (``decode_attention.plan``, ``workspace_floats``); the
tests count those words by hand at smollm-360m's shapes.  Every plan cache
here is an explicit temporary path, and both packages' tile caches are off.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs.registry import get as rget
from repro.core import costmodel as rcm
from repro.core import energy as ren
from repro.core import serveplan as rsp
from repro.core.jsonstore import load_json_dict
from repro_torch import hw
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.registry import get as tget
from repro_torch.core import costmodel as tcm
from repro_torch.core import energy as ten
from repro_torch.core import serveplan as tsp
from repro_torch.kernels.flash_attention import decode_attention as dec
from repro_torch.kernels.matmul import matmul as mm

ROOT = Path(__file__).resolve().parents[1]
TPU = tsp.ServeHardware.tpu_v5e()
# (concurrency, prompt_len, decode_len)
WORKLOADS = [(16, 16, 16), (16, 230, 56), (4, 64, 256)]


@pytest.fixture(autouse=True)
def _no_tile_caches(monkeypatch):
    monkeypatch.setenv("REPRO_TILE_CACHE", "")
    monkeypatch.setenv("REPRO_TORCH_TILE_CACHE", "")


def _cost_view(c):
    return (c.rows, c.admitted, c.flops, c.hbm_words, c.smem_words, c.kv_pool_bytes,
            c.roofline_s, c.ttft_steps, c.paged_blocks, c.chunked, c.energy_pj())


def _ref_cost_view(c):
    return (c.rows, c.admitted, c.flops, c.hbm_words, c.vmem_words, c.kv_pool_bytes,
            c.roofline_s, c.ttft_steps, c.paged_blocks, c.chunked, c.energy_pj())


def test_tpu_description_is_the_reference_default():
    ref = rsp.ServeHardware()
    assert TPU.fingerprint() == ref.fingerprint()
    assert [(lv.name, lv.capacity_bytes, lv.bandwidth_words_per_cycle) for lv in TPU.levels()] \
        == [(lv.name, lv.capacity_bytes, lv.bandwidth_words_per_cycle) for lv in ref.levels()]


@pytest.mark.parametrize("arch,max_len", [("smollm-360m-smoke", 64), ("smollm-360m", 1024)])
def test_price_decode_step_on_tpu_matches_the_reference(arch, max_len):
    rc, tc = rget(arch), tget(arch)
    wl = (16, 230, 56)
    for layout in ("paged", "contiguous"):
        for bs in (8, 16, 32):
            for chunk, budget in ((0, None), (16, 32)):
                kw = dict(slots=8, kv_layout=layout, block_size=bs, prefill_chunk=chunk,
                          token_budget=budget,
                          num_blocks=8 * max_len // bs + 1 if layout == "paged" else None)
                got = tsp.price_decode_step(tc, tsp.ServeKnobs(**kw), max_len=max_len,
                                            workload=tsp.ServeWorkload(*wl), hardware=TPU)
                want = rsp.price_decode_step(rc, rsp.ServeKnobs(**kw), max_len=max_len,
                                             workload=rsp.ServeWorkload(*wl))
                assert _cost_view(got) == _ref_cost_view(want), kw
                assert got.breakdown["smem_capacity_bytes"] == want.breakdown[
                    "vmem_capacity_bytes"]


@pytest.mark.parametrize("arch,max_len", [("smollm-360m-smoke", 64), ("smollm-360m", 1024)])
@pytest.mark.parametrize("wl", WORKLOADS)
def test_plan_serve_on_tpu_matches_the_reference(arch, max_len, wl):
    got = tsp.plan_serve(tget(arch), max_len=max_len, workload=tsp.ServeWorkload(*wl),
                         hardware=TPU, cache=False)
    want = rsp.plan_serve(rget(arch), max_len=max_len, workload=rsp.ServeWorkload(*wl),
                          cache=False)
    assert got.knobs.as_dict() == want.knobs.as_dict()
    assert got.predicted == want.predicted
    assert got.frontier_size == want.frontier_size


def test_plan_key_on_tpu_is_the_reference_key():
    cfg, ws = tget("smollm-360m"), (16, 230, 56)
    args = (1024, tsp.ServeWorkload(*ws), TPU, tsp.ServePlanSpace(), 32 * 1024,
            tsp.Calibration(1e-3, 2e-5, 0.0, 3e-4))
    rargs = (1024, rsp.ServeWorkload(*ws), rsp.ServeHardware(), rsp.ServePlanSpace(), 32 * 1024,
             rsp.Calibration(1e-3, 2e-5, 0.0, 3e-4))
    assert tsp._plan_key(cfg, *args) == rsp._plan_key(rget("smollm-360m"), *rargs)
    h100 = tsp._plan_key(cfg, args[0], args[1], tsp.ServeHardware(), *args[3:])
    assert h100 != tsp._plan_key(cfg, *args)


def _anchor_costs(sp, cfg, **hw_kw):
    wl = sp.ServeWorkload(16, 230, 56)
    mk = lambda **kw: sp.price_decode_step(cfg, sp.ServeKnobs(**kw), max_len=1024,
                                           workload=wl, **hw_kw)
    return [
        mk(slots=4, kv_layout="contiguous", block_size=16),
        mk(slots=16, kv_layout="contiguous", block_size=16),
        mk(slots=16, kv_layout="paged", block_size=16, num_blocks=1025),
        mk(slots=16, kv_layout="paged", block_size=16, num_blocks=1025, prefill_chunk=32,
           token_budget=32),
        mk(slots=8, kv_layout="contiguous", block_size=32, prefill_chunk=16, token_budget=16),
    ]


def test_calibration_fit_matches_the_reference():
    tc = _anchor_costs(tsp, tget("smollm-360m"), hardware=TPU)
    rc = _anchor_costs(rsp, rget("smollm-360m"))
    measured = [0.0345, 0.0361, 0.0702, 0.0754, 0.0402]
    for n in (1, 2, 4, 5):
        got = tsp.Calibration.fit(list(zip(tc[:n], measured[:n])))
        want = rsp.Calibration.fit(list(zip(rc[:n], measured[:n])))
        assert got.fingerprint() == want.fingerprint()
        assert tuple(vars(got).values()) == tuple(vars(want).values())
        assert [c.step_s(got) for c in tc] == [c.step_s(want) for c in rc]
    # the H100's roofline is a small part of a host-bound step: the terms
    # carry it, and each anchor is fitted back
    hc = _anchor_costs(tsp, tget("smollm-360m"))
    calib = tsp.Calibration.fit(list(zip(hc[:4], measured[:4])))
    for c, m in zip(hc[:4], measured[:4]):
        assert c.roofline_s < 0.05 * m
        assert c.step_s(calib) == pytest.approx(m, rel=1e-9)


def test_knob_validation_matches_the_reference():
    cases = [
        dict(slots=4, kv_layout="paged", block_size=16, num_blocks=17),
        dict(slots=0, block_size=16),
        dict(slots=4, kv_layout="ring", block_size=16),
        dict(slots=4, block_size=48),
        dict(slots=4, block_size=16, num_blocks=1),
        dict(slots=4, kv_layout="contiguous", block_size=16, num_blocks=8),
        dict(slots=4, block_size=16, prefill_chunk=0, token_budget=16),
        dict(slots=4, block_size=16, prefill_chunk=32, token_budget=16),
        dict(slots=4, block_size=16, prefill_chunk=48),
        dict(slots=2.0, block_size=16),
    ]
    for kw in cases:
        outcome = []
        for sp in (tsp, rsp):
            try:
                sp.ServeKnobs(**kw).validate(64)
                outcome.append("ok")
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], kw
    assert tsp.ServeKnobs.from_dict(tsp.ServeKnobs(**cases[0]).as_dict()) == tsp.ServeKnobs(
        **cases[0])


def test_plan_cache_roundtrip_and_corrupt_entry_match_the_reference(tmp_path):
    out = []
    for name, sp, cfg, hw_kw in (("port", tsp, tget("smollm-360m-smoke"), dict(hardware=TPU)),
                                 ("ref", rsp, rget("smollm-360m-smoke"), {})):
        path = str(tmp_path / f"{name}.json")
        p1 = sp.plan_serve(cfg, max_len=64, cache=path, **hw_kw)
        p2 = sp.plan_serve(cfg, max_len=64, cache=path, **hw_kw)
        assert (p1.source, p2.source) == ("search", "cache")
        data = load_json_dict(path)
        (key,) = data.keys()
        data[key]["knobs"]["block_size"] = -5  # corrupt in place
        with open(path, "w") as f:
            json.dump(data, f)
        p3 = sp.plan_serve(cfg, max_len=64, cache=path, **hw_kw)
        assert p3.source == "search"
        healed = load_json_dict(path)
        out.append((key, p1.knobs.as_dict(), p2.knobs.as_dict(), p3.knobs.as_dict(),
                    p2.predicted, healed))
    assert out[0] == out[1]


def test_plan_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv(tsp._PLAN_CACHE_ENV, raising=False)
    assert tsp._plan_cache_path() == str(ROOT / "build" / "repro_torch" / "serve_plans.json")
    monkeypatch.setenv(tsp._PLAN_CACHE_ENV, "")
    assert tsp._plan_cache_path() is None
    path = tmp_path / "plans.json"
    monkeypatch.setenv(tsp._PLAN_CACHE_ENV, str(path))
    plan = tsp.plan_serve(tget("smollm-360m-smoke"), max_len=64)
    assert plan.source == "search" and path.exists()
    assert tsp.plan_serve(tget("smollm-360m-smoke"), max_len=64).source == "cache"


# ------------------------------------------------------------- the H100 --


def _smollm_h100(knobs, rows=8):
    cfg = tget("smollm-360m")
    wl = tsp.ServeWorkload(concurrency=rows, prompt_len=230, decode_len=56)
    return cfg, tsp.price_decode_step(cfg, knobs, max_len=1024, workload=wl)


def test_h100_gemm_words_are_the_kernels_by_hand():
    """smollm-360m's five decode GEMMs at 8 rows: the skinny body (one M
    tile of the 8-row bucket), so the weight crosses HBM once; the
    activation rows once; the output once."""
    cfg = tget("smollm-360m")
    d, hd, L = 960, 64, 32
    shapes = [((15 + 2 * 5) * hd, d, L), (d, 15 * hd, L), (2 * 2560, d, L), (d, 2560, L),
              (49152, d, 1)]
    assert [(n, k, m) for _, n, k, m in tsp.decode_gemms(cfg)] == shapes
    words = 0
    for N, K, mult in shapes:
        plan = mm.plan(8, N, K)
        assert (plan.body, plan.bm) == ("skinny", 8) and plan.smem <= hw.SMEM_PER_BLOCK_BYTES
        assert tsp._gemm_hbm_words(tsp.ServeHardware(), 8, N, K) == K * N + 8 * K + 8 * N
        words += mult * (K * N + 8 * K + 8 * N)
    knobs = tsp.ServeKnobs(slots=8, kv_layout="contiguous", block_size=16)
    _, cost = _smollm_h100(knobs)
    assert cost.breakdown["gemm_words"] == words
    # the weights: every counted parameter crosses HBM once a step
    assert sum(mult * N * K for N, K, mult in shapes) == cfg.params_count()
    # the wide body past 64 rows reads the weight once per 128-row tile
    plan = mm.plan(200, 960, 960)
    assert plan.body == "wide"
    assert tsp._gemm_hbm_words(tsp.ServeHardware(), 200, 960, 960) == (
        960 * 960 * 2 + 200 * 960 + 200 * 960)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_h100_attention_words_are_the_kernels_by_hand(layout, bs):
    """One row and layer of smollm-360m's decode attention at a 258-token
    mean context: ceil(258 / bs) whole K and V splits per kv head, int32
    table entries (paged), and per live split and kv head the fp32
    workspace the kernel writes and reads back: 3 score rows of bs keys
    (padded to 4) and 3 x (64 + 2) partials."""
    KV, G, d, ctx = 5, 3, 64, 230 + 56 // 2
    blocks = -(-ctx // bs)
    kv_words = 2 * blocks * bs * KV * d
    table = 2 * blocks if layout == "paged" else 0
    ws_floats = KV * blocks * G * (-(-bs // 4) * 4 + d + 2)
    assert dec.workspace_floats(1, KV, G, d, bs, blocks) == ws_floats
    row = kv_words + table + 2 * 2 * ws_floats
    nb = 16 * 1024 // bs + 1 if layout == "paged" else None
    knobs = tsp.ServeKnobs(slots=8, kv_layout=layout, block_size=bs, num_blocks=nb)
    cfg, cost = _smollm_h100(knobs)
    per_row = row + 2 * 15 * d + 2 * KV * d  # q read and output written; the K/V write
    assert cost.breakdown["attention_words"] == 8 * 32 * per_row
    assert cost.paged_blocks == (8 * blocks if layout == "paged" else 0.0)
    p = dec.plan(8, KV, G, d, bs, 1024 // bs, 2)
    assert dec.smem_bytes(G, d, bs, 2, p.ts, p.nbuf) <= hw.SMEM_PER_BLOCK_BYTES


def test_h100_roofline_and_default_plan():
    cfg = tget("smollm-360m")
    knobs = tsp.ServeKnobs(slots=8, kv_layout="contiguous", block_size=16)
    _, cost = _smollm_h100(knobs)
    hbm_s = cost.hbm_words * 2 / hw.HBM_BYTES_PER_S
    assert cost.roofline_s == pytest.approx(max(cost.flops / hw.BF16_FLOPS_PER_S, hbm_s),
                                            rel=1e-12)
    # 0.72 GB of bf16 weights at 3.35 TB/s, plus the KV: about 0.25 ms
    assert 0.2e-3 < cost.roofline_s < 0.4e-3
    assert tsp.ServeHardware().levels()[0].capacity_bytes == hw.hopper_gemm_levels()[1].capacity_bytes
    plan = tsp.plan_serve(cfg, max_len=1024, workload=tsp.ServeWorkload(16, 230, 56),
                          cache=False)
    assert plan.knobs.slots >= 16 and plan.predicted["rows"] == 16
    assert plan.predicted["swept_points"] == 90


def test_empty_space_raises_with_the_reference_message():
    space = dict(slot_counts=(2,), block_sizes=(48,))
    with pytest.raises(ValueError) as got:
        tsp.plan_serve(tget("smollm-360m-smoke"), max_len=64,
                       space=tsp.ServePlanSpace(**space), cache=False)
    with pytest.raises(ValueError) as want:
        rsp.plan_serve(rget("smollm-360m-smoke"), max_len=64,
                       space=rsp.ServePlanSpace(**space), cache=False)
    assert str(got.value) == str(want.value)
    assert "no feasible serve configuration" in str(got.value)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_non_dense_models_are_refused(arch):
    cfg = tget(arch)
    if cfg.family in ("dense", "vlm") and not cfg.sliding_window:
        tsp.sweep_serve_space(cfg.smoke(), max_len=64)
        return
    with pytest.raises(ValueError, match="dense decoder-only") as got:
        tsp.plan_serve(cfg, max_len=64, cache=False)
    if cfg.mixer != "attention" or cfg.moe is not None:  # the reference's refusals
        with pytest.raises(ValueError) as want:
            rsp.plan_serve(rget(arch), max_len=64, cache=False)
        assert str(got.value) == str(want.value)


def test_importing_the_planner_loads_no_torch():
    probe = ("import sys, repro_torch.core, repro_torch.core.serveplan; "
             "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


def test_gather_and_abft_pricing_match_the_reference():
    """energy.attention_gather_cost (scalar), costmodel.attention_gather_words
    (vectorized) and the ABFT surcharge, on numpy-seeded cases."""
    rng = np.random.default_rng(3)
    ctx = rng.integers(1, 5000, 64)
    bs = rng.choice([8, 16, 32, 64], 64)
    splits = rng.integers(0, 200, 64)
    for kw in (dict(), dict(kv_splits=splits)):
        got = tcm.attention_gather_words(ctx, bs, kv_heads=5, head_dim=64, **kw)
        assert got.tolist() == rcm.attention_gather_words(ctx, bs, kv_heads=5, head_dim=64,
                                                          **kw).tolist()
        for i in range(64):
            one = ten.attention_gather_cost(
                int(ctx[i]), block_size=int(bs[i]), kv_heads=5, head_dim=64,
                kv_splits=int(splits[i]) if kw else None)
            assert one.words == got[i]
            assert vars(one) == vars(ren.attention_gather_cost(
                int(ctx[i]), block_size=int(bs[i]), kv_heads=5, head_dim=64,
                kv_splits=int(splits[i]) if kw else None))
    table = ten.CostTable(level_pj=(1.0, 6.0, 200.0), mac_pj=1.0, hop_pj=2.0)
    rtable = ren.CostTable(level_pj=(1.0, 6.0, 200.0), mac_pj=1.0, hop_pj=2.0)
    for M, N, K, bm in ((8, 960, 960, 8), (37, 2560, 960, 16), (2176, 960, 2560, 64)):
        got, want = ten.abft_matmul_cost(M, N, K, bm), ren.abft_matmul_cost(M, N, K, bm)
        assert vars(got) == vars(want) and got.ops == want.ops
        assert ten.abft_energy_pj(got, table) == ren.abft_energy_pj(want, rtable)
    assert ten.serve_step_energy_pj(1e9, 3e8, 2e9, 64 * 2**20) == ren.serve_step_energy_pj(
        1e9, 3e8, 2e9, 64 * 2**20)
