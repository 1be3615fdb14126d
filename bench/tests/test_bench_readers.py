"""The yardstick's arithmetic on hand-worked shapes (work counts, bounds,
operation counts of a step) and every per-layer metric's reader on a
synthetic run, and the serving window's statistics on synthetic stamps."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench.harness import model as bmodel
from bench.harness import peaks, registry, serve, spans, train

DIMS = {"layers": 2, "d_model": 8, "heads": 4, "kv_heads": 2, "head_dim": 2, "d_ff": 16,
        "vocab": 10, "experts": 0, "top_k": 0}


def test_gemm_work():
    count = registry.load_module("work", "gemm").count
    a, b = torch.zeros(2, 3, dtype=torch.bfloat16), torch.zeros(3, 4, dtype=torch.bfloat16)
    assert count({}, (a, b), {}) == (2 * 2 * 4 * 3, (6 + 12 + 8) * 2)
    bt = torch.zeros(4, 3, dtype=torch.bfloat16)
    assert count({}, (a, bt), {"trans_b": True}) == (48, 52)


def test_decode_attention_work():
    count = registry.load_module("work", "decode_attention").count
    q = torch.zeros(3, 2, 2, 2, dtype=torch.bfloat16)
    ctx = {"dims": DIMS, "live_rows": 2, "live_tokens": 10}
    # keys and values 10 x 2 heads x 2 x 2 B each; query and output 2 rows x 4 x 2 x 2 B
    assert count(ctx, (q,), {}) == (4 * 10 * 4 * 2, 2 * 10 * 2 * 2 * 2 + 2 * 2 * 4 * 2 * 2)


def test_paged_decode_attention_work_counts_a_shared_block_once():
    count = registry.load_module("work", "decode_attention_paged").count
    # pool of 8 blocks of 4 tokens; block 0 is the sink.  Rows 0 and 1
    # share block 1 (a full prefix block), then own blocks 2 and 3; row 2
    # is dead (its table aimed at the sink, its length still growing)
    tables = torch.tensor([[1, 2, 0], [1, 3, 0], [0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([6, 7, 9], dtype=torch.int32)
    kpool = torch.zeros(8, 4, 2, 2, dtype=torch.bfloat16)
    q = torch.zeros(3, 2, 2, 2, dtype=torch.bfloat16)  # (B, KV, G, d)
    ctx = {"step": 1}
    flops, nbytes = count(ctx, (q, kpool, kpool, tables, lengths), {})
    # unique tokens: block 1 four, block 2 two, block 3 three; 2 live rows
    # of 13 tokens; keys and values 9 x 2 heads x 2 x 2 B, query and output
    # 2 rows x 4 x 2 x 2 B
    assert (flops, nbytes) == (4.0 * 13 * 4 * 2, 2 * 9 * 2 * 2 * 2 + 2 * 2 * 4 * 2 * 2)
    # the same step reads the tables once; the next step reads them again
    assert count(ctx, (q, kpool, kpool, tables[:, :0], lengths), {}) == (flops, nbytes)
    ctx["step"] = 2
    tables[1, 0] = 4  # no sharing: row 1 holds its own first block
    assert count(ctx, (q, kpool, kpool, tables, lengths), {})[1] == nbytes + 4 * 2 * 2 * 2 * 2


def test_step_operations():
    p = bmodel.param_counts(DIMS)
    # attention 8 x (4 + 4) x 2 + 8 x 8, the MLP 3 x 8 x 16
    assert p == {"layer": 128 + 64 + 384, "layer_active": 576, "unembed": 80}
    dec = registry.load_module("work", "decode_step").count
    ctx = {"dims": DIMS, "live_rows": 3, "live_tokens": 20}
    assert dec(ctx, (), {}) == (3 * 2 * (2 * 576 + 80) + 4 * 2 * 4 * 2 * 20, 0)
    pre = registry.load_module("work", "prefill").count
    toks = torch.zeros(2, 5)
    per = 2 * 2 * 576 * 5 + 4 * 2 * 4 * 2 * 15 + 2 * 80
    assert pre(ctx, (None, None, toks), {}) == (2 * per, 0)
    moe = {**DIMS, "experts": 4, "top_k": 2}
    pm = bmodel.param_counts(moe)
    assert pm["layer_active"] == 192 + 8 * 4 + 2 * 384 and pm["layer"] == 192 + 32 + 4 * 384


def test_train_operations():
    p = bmodel.param_counts(DIMS)
    assert train.train_flops(DIMS, 3, 4) == 3 * (6 * (2 * 576 + 80) * 4 + 12 * 2 * 4 * 2 * 10)


def test_bound_is_the_larger_of_the_two_times():
    assert spans.bound_s(peaks.BF16_FLOPS_PER_S, 0) == pytest.approx(1.0)
    assert spans.bound_s(1.0, peaks.HBM_BYTES_PER_S * 2) == pytest.approx(2.0)


def _view():
    sl = SimpleNamespace(
        window_s=2.0, steps=4, busy_s=0.5,
        calls={"decode_step": 4, "moe_apply": 8, "apply_updates": 2},
        flops={"decode_step": 0.5 * peaks.BF16_FLOPS_PER_S, "prefill": 0.5 * peaks.BF16_FLOPS_PER_S,
               "train_step": peaks.BF16_FLOPS_PER_S},
        bytes={}, bound_s={"matmul": 0.01, "decode_attention_paged": 0.002},
        host_s={},
        device_ms={"matmul@decode_step": 30.0, "matmul@prefill": 20.0,
                   "decode_attention_paged@decode_step": 8.0, "moe_apply@decode_step": 12.0,
                   "moe_apply@prefill": 100.0, "apply_updates": 6.0})
    return SimpleNamespace(
        host_s={"engine_step": 1.0, "prefill": 0.3, "decode_step": 0.4, "sample": 0.1},
        calls={"engine_step": 10, "decode_step": 8}, prefill_lat=[0.1, 0.3], slice=sl)


@pytest.mark.parametrize("name,want", [
    ("engine_host_ms.serve", 1e3 * 0.2 / 10),
    ("decode_issue_ms.serve", 1e3 * 0.4 / 8),
    ("prefill_ms.serve", 200.0),
    ("moe_ms.decode", 3.0),
    ("gemm_roofline.serve", 100 * 0.01 / 0.05),
    ("decode_attn_roofline.serve", 100 * 0.002 / 0.008),
    ("mfu.serve", 50.0),
    ("mfu.train", 50.0),
    ("device_idle.serve", 75.0),
    ("device_idle.train", 75.0),
    ("optim_ms.train", 3.0),
])
def test_readers(name, want):
    assert registry.load_module("metrics", name).read(_view()) == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in registry.benchmark()["per_layer"]])
def test_device_readers_say_nothing_without_a_trace(name):
    v = _view()
    v.slice = None
    m = next(m for m in registry.benchmark()["per_layer"] if m["name"] == name)
    got = registry.load_module("metrics", name).read(v)
    assert (got is None) == (m["source"] == "device_trace")


def test_window_latency():
    R = serve.Req
    reqs = {
        0: R(None, 3, 0.5, stamps=[0.9, 1.2, 1.6]),   # submitted before the window
        1: R(None, 2, 1.0, stamps=[1.5, 2.5]),        # ttft 0.5; second token after t1
        2: R(None, 4, 1.8, stamps=[]),                # still waiting at t1: 0.2
    }
    got = serve.window_latency(reqs, 1.0, 2.0)
    assert got["tokens"] == 3 and got["out_tok_s"] == 3.0
    assert got["ttft_n"] == 2 and got["ttft_p95_ms"] == pytest.approx(
        1e3 * serve.percentile([0.5, 0.2], 95))
    assert got["itl_n"] == 1 and got["itl_p95_ms"] == pytest.approx(400.0)


def test_sample_holds_the_longest():
    reqs = {i: serve.Req(None, 1, 0.0, tokens=[0] * n) for i, n in enumerate([3, 9, 4, 9, 2])}
    got = serve.sample([0, 1, 2, 3, 4], reqs, 3, seed=1)
    assert got[0] == 1 and len(set(got)) == 3
    assert got == serve.sample([0, 1, 2, 3, 4], reqs, 3, seed=1)


def test_compare_by_the_worst_leaf():
    ref = {"losses": [2.0, 1.9], "first_grad": {"a": 1.0, "b": 2.0, "c": 1e-6},
           "change": {"a": 0.5, "b": 1.0, "c": 0.3}}
    prog = {"losses": [2.1, 1.9], "first_grad": {"a": 1.1, "b": 2.0, "c": 0.0},
            "change": {"a": 0.5, "b": 0.0, "c": 9.9}}
    got = train.compare(prog, ref)
    assert got["loss_gap"] == pytest.approx(0.1)
    # a: |1.1 - 1| / max(1, median 1) ; c is measured against the median leaf
    assert got["grad_gap"] == pytest.approx(0.1)
    # c's reference gradient is under a thousandth of the median: left out
    assert got["change_gap"] == pytest.approx(1.0)
