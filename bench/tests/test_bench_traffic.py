"""The traffic generators: a seed repeats its requests exactly, every seed
asks for the same sizes, and the sizes follow the mix's parameters, whose
sourced medians the chat mix keeps."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench.harness import registry

closed_loop = registry.generator("closed_loop")
pretrain = registry.generator("pretrain")


def _mix(name):
    return registry.load_json("traffic", name)


def _take(loop, n):
    out = loop.first_round()
    while len(out) < n:
        out += loop.due(min(3, n - len(out)), 0.0)
    return out


@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**33 + 11])
def test_a_seed_repeats_and_another_seed_changes_only_the_tokens(seed):
    mix = _mix("chat")
    a = _take(closed_loop.make(mix, 49152, seed), 400)
    b = _take(closed_loop.make(mix, 49152, seed), 400)
    c = _take(closed_loop.make(mix, 49152, seed + 1), 400)
    assert all(np.array_equal(p, q) and m == n for (p, m), (q, n) in zip(a, b))
    assert [(len(p), m) for p, m in a] == [(len(p), m) for p, m in c]
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in zip(a, c))


@pytest.mark.parametrize("name", ["chat"])
def test_sizes_follow_the_mix(name):
    mix = _mix(name)
    s = closed_loop.pool_sizes(mix)
    for key, lens in (("prompt", s.own), ("output", s.out)):
        spec = mix[key]
        assert lens.min() >= spec["min"] and lens.max() <= spec["max"]
        # the log-normal's median, before clipping moves it
        assert np.median(lens) == pytest.approx(spec["median"], rel=0.05)
    sp = mix.get("shared_prefixes")
    if sp:
        counts = np.bincount(s.prefix, minlength=sp["count"]) / len(s.prefix)
        zipf = 1.0 / np.arange(1, sp["count"] + 1) ** sp["zipf_s"]
        assert counts == pytest.approx(zipf / zipf.sum(), abs=0.02)
    else:
        assert (s.prefix == -1).all()


def test_shared_prompts_open_the_requests_that_pick_them():
    mix = _mix("chat")
    loop = closed_loop.make(mix, 1000, 5)
    reqs = _take(loop, 64)
    for i, (prompt, _) in enumerate(reqs):
        k = loop.sizes.prefix[i]
        assert np.array_equal(prompt[: mix["shared_prefixes"]["tokens"]], loop.prefixes[k])
        assert len(prompt) == mix["shared_prefixes"]["tokens"] + loop.sizes.own[i]


def test_first_round_budgets_are_staggered():
    mix = {**_mix("chat"), "clients": 8}
    loop = closed_loop.make(mix, 1000, 5)
    budgets = [m for _, m in loop.first_round()]
    full = loop.sizes.out[:8]
    assert budgets == [max(1, -(-int(full[c]) * (c + 1) // 8)) for c in range(8)]


def test_pretrain_batches_repeat_differ_by_row_and_shift_labels():
    mix = _mix("pretrain")
    small = {**mix, "seq_len": 32, "rows": 6}
    a = pretrain.batches(small, 500, 11, 3)
    b = pretrain.batches(small, 500, 11, 3)
    for x, y in zip(a, b):
        assert np.array_equal(x["tokens"], y["tokens"])
    t = a[0]["tokens"]
    assert len({tuple(r) for r in t}) == small["rows"]
    assert not np.array_equal(a[0]["tokens"], a[1]["tokens"])
    assert np.array_equal(a[0]["tokens"][:, 1:], a[0]["labels"][:, :-1])
    # a token follows from the one before far above chance (1 / 500); the
    # rule reads the token drawn before, which may itself have been replaced
    nxt = (t[:, :-1] * 31 + 7) % 500
    assert (t[:, 1:] == nxt).mean() > 0.1


def test_mix_files_are_data():
    for path in (registry.BENCH / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv"), path
        json.loads(path.read_text())


def test_chat_keeps_the_sourced_medians_and_fits_the_context():
    """Splitwise's conversation medians: prompt 1020, output 129 tokens."""
    mix = _mix("chat")
    s = closed_loop.pool_sizes(mix)
    prompt = s.own + mix["shared_prefixes"]["tokens"]
    assert np.median(prompt) == pytest.approx(1020, rel=0.01)
    assert np.median(s.out) == pytest.approx(129, rel=0.02)
    assert (prompt + s.out).max() <= 2048


def test_closed_loop_sends_one_request_for_each_that_finished():
    loop = closed_loop.make(_mix("chat"), 1000, 5)
    assert len(loop.first_round()) == _mix("chat")["clients"]
    assert loop.due(0, 1.0) == [] and len(loop.due(3, 2.0)) == 3


def test_every_mix_names_a_generator():
    for path in (registry.BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        gen = registry.generator(mix["kind"])
        assert callable(getattr(gen, "make", None)) or callable(getattr(gen, "batches", None))
