"""The port's lifecycle chaos episodes (``repro_torch.serve.chaos``), after
the reference's ``tests/test_chaos.py``.

Each episode drives a seeded workload with priorities and deadlines through
a reused engine while a seeded schedule injects cancels, re-cancels of
terminal requests, forced preemptions (active and prefilling) and
block-pressure spikes; ownership is audited after every step and the
drained end state must agree bitwise with an unfaulted oracle engine
(FINISHED outputs equal, every other output a prefix).  ``smollm-360m-smoke``
in float32 with the port's own weights, on the CPU.  Replay one episode
with ``CHAOS_EPISODES=1 CHAOS_SEED=<seed - 1000> PYTHONPATH=src python -m
pytest -q tests/test_torch_chaos_lifecycle.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import chaos_episodes, chaos_seed
from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import _env, chaos
from repro_torch.serve import engine as te

MAX_LEN, BS = 64, 8


@pytest.fixture(scope="module")
def smol():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _scfg(layout="contiguous", decode_block=BS, **sched):
    kv = (te.KVConfig(layout="paged", block_size=BS, num_blocks=sched.pop("num_blocks", None))
          if layout == "paged" else te.KVConfig(decode_block=decode_block))
    return te.ServeConfig(
        max_len=MAX_LEN, temperature=0.7, seed=5,
        scheduler=te.SchedulerConfig(batch=3, prefill_bucket=16, **sched), kv=kv,
    )


def _setups(cfg, params):
    """Four reused (faulted engine, oracle engine) pairs, as the
    reference's: an ample paged pool, the chunked lane (cancels,
    preemptions and spikes land on PREFILLING requests too), a
    block-starved pool (11 usable blocks against 3 slots wanting up to 64
    tokens each: admission waits, spikes drain the pool, the watchdog
    sheds, and preemption is the only way a head jumps) and the contiguous
    layout.  The oracle is the contiguous engine with the paged block size
    as its decode split."""
    oracle = te.Engine(cfg, params, _scfg(), device="cpu")
    return [
        ("paged-ample", te.Engine(cfg, params, _scfg("paged", stall_patience=6), device="cpu")),
        ("paged-chunked", te.Engine(cfg, params, _scfg(
            "paged", prefill_chunk=BS, token_budget=BS, stall_patience=6), device="cpu")),
        ("paged-starved", te.Engine(cfg, params, _scfg(
            "paged", num_blocks=12, stall_patience=4, max_waiting=8), device="cpu")),
        ("contiguous", te.Engine(cfg, params, _scfg(stall_patience=6), device="cpu")),
    ], oracle


@pytest.mark.chaos
def test_chaos_episode_matrix(smol):
    """Seeded episodes across the four setups: every step audited, drains
    leak-free, outputs bitwise the oracle's (or its prefixes), and across
    the set every fault type fired."""
    cfg, params = smol
    setups, oracle_eng = _setups(cfg, params)
    ccfg = chaos.ChaosConfig()
    reports = []
    for ep in range(chaos_episodes(16)):
        name, eng = setups[ep % len(setups)]
        seed = chaos_seed() + chaos.SEED_STRIDE + ep
        reqs = chaos.make_chaos_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN, ccfg)
        oracle = chaos.oracle_outputs(oracle_eng, reqs)
        reports.append((name, chaos.run_episode(eng, oracle, reqs, seed, ccfg)))
    total: dict[str, int] = {}
    for _, rep in reports:
        for k, v in rep.stats.items():
            total[k] = total.get(k, 0) + v
    for key in ("cancelled", "preempted", "recovered", "replayed", "expired"):
        assert total[key] > 0, f"no {key} event in the whole matrix"
    assert sum(r.statuses.get("FINISHED", 0) for _, r in reports) > 0
    # preemptions landed on every setup, the lane's included
    for name in {n for n, _ in reports}:
        assert sum(r.stats["preempted"] for n, r in reports if n == name) > 0, name


@pytest.mark.chaos
def test_chaos_episode_replays_identically(smol):
    """An episode is a pure function of (engine config, seed): the same seed
    gives the same steps, statuses and lifecycle counters."""
    cfg, params = smol
    ccfg = chaos.ChaosConfig()
    seed = chaos_seed() + 77

    def once():
        eng = te.Engine(cfg, params, _scfg("paged", stall_patience=6), device="cpu")
        oracle_eng = te.Engine(cfg, params, _scfg(), device="cpu")
        reqs = chaos.make_chaos_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN, ccfg)
        return chaos.run_episode(eng, chaos.oracle_outputs(oracle_eng, reqs), reqs, seed, ccfg)

    a, b = once(), once()
    assert (a.steps, a.statuses, a.stats) == (b.steps, b.statuses, b.stats)


@pytest.mark.chaos
def test_chaos_spike_starves_then_recovers(smol):
    """An external reservation takes the whole pool mid-flight: admission
    stalls without shedding or corrupting anything, and once the blocks
    return the queue drains with bitwise-intact outputs."""
    cfg, params = smol
    scfg = dataclasses.replace(_scfg("paged", stall_patience=100), temperature=0.0)
    scfg.scheduler = dataclasses.replace(scfg.scheduler, batch=2)
    eng = te.Engine(cfg, params, scfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 20).astype(np.int32) for _ in range(3)]
    for i, p in enumerate(prompts):
        eng.submit(te.Request(p, 6, request_id=i))
    eng.step()  # admit what fits
    held = eng.pool.reserve(eng.pool.free_blocks)  # drain the pool
    for _ in range(8):
        eng.step()
        held += eng.pool.reserve(eng.pool.free_blocks)  # keep it at zero
        chaos.audit(eng)
    assert eng.status(2) == te.RequestStatus.WAITING, "admission should stall"
    eng.pool.unreserve(held)
    while eng.step():
        chaos.audit(eng)
    assert eng.status(2) == te.RequestStatus.FINISHED
    solo = te.Engine(cfg, params, dataclasses.replace(_scfg(), temperature=0.0), device="cpu")
    want = solo.run([te.Request(prompts[2], 6, request_id=2)])[0]
    assert eng.pop_result(2).tolist() == want.tolist()
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1


def test_workload_draws_match_the_reference_sequence():
    """``make_chaos_workload`` makes the reference's draws in the
    reference's order, so a seed names the same workload in both
    packages."""
    jchaos = pytest.importorskip("repro.serve.chaos")
    ccfg = chaos.ChaosConfig(n_requests=12)
    jccfg = jchaos.ChaosConfig(n_requests=12)
    a = chaos.make_chaos_workload(np.random.default_rng(9), 256, MAX_LEN, ccfg)
    b = jchaos.make_chaos_workload(np.random.default_rng(9), 256, MAX_LEN, jccfg)
    assert [(r.prompt.tolist(), r.max_new, r.priority, r.deadline_steps) for r in a] == [
        (r.prompt.tolist(), r.max_new, r.priority, r.deadline_steps) for r in b]
    assert any(r.priority for r in a) and any(r.deadline_steps is not None for r in a)
    assert all(len(r.prompt) <= MAX_LEN - 4 for r in a)


def test_env_int_parses_and_rejects(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_KNOB", raising=False)
    assert _env.env_int("REPRO_TORCH_KNOB", 7) == 7
    monkeypatch.setenv("REPRO_TORCH_KNOB", " 12 ")
    assert _env.env_int("REPRO_TORCH_KNOB", 7) == 12
    monkeypatch.setenv("REPRO_TORCH_KNOB", "lots")
    with pytest.raises(ValueError, match="REPRO_TORCH_KNOB='lots' is not an integer"):
        _env.env_int("REPRO_TORCH_KNOB", 7)
