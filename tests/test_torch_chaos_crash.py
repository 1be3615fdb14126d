"""The port's crash chaos episodes (``chaos.run_crash_episode``), after the
reference's ``tests/test_chaos.py::test_crash_restart_episode_matrix``.

Each episode builds a durable engine (snapshots and a journal on disk),
drives it through the lifecycle fault schedule with client result pops,
simulates a process kill at a seeded step (sometimes flipping a byte of
the newest snapshot too), restores and finishes the workload: ownership is
audited every step, the drain is leak-free, every request agrees bitwise
with an unfaulted oracle (FINISHED equal, the rest prefixes) and no popped
result comes back.  ``smollm-360m-smoke`` in float32 with the port's own
weights, on the CPU.  Replay one episode with ``RECOVERY_EPISODES=1
CHAOS_SEED=<seed - 1000> PYTHONPATH=src python -m pytest -q
tests/test_torch_chaos_crash.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import chaos_seed, recovery_episodes
from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import chaos
from repro_torch.serve import engine as te

MAX_LEN, BS = 64, 8


@pytest.fixture(scope="module")
def smol():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _scfg(layout="contiguous", snapshot_dir=None, **sched):
    kv = (te.KVConfig(layout="paged", block_size=BS, num_blocks=sched.pop("num_blocks", None))
          if layout == "paged" else te.KVConfig(decode_block=BS))
    return te.ServeConfig(
        max_len=MAX_LEN, temperature=0.7, seed=5,
        scheduler=te.SchedulerConfig(batch=3, prefill_bucket=16, **sched), kv=kv,
        durability=te.DurabilityConfig(snapshot_dir=snapshot_dir, snapshot_every=4,
                                       snapshot_keep=2),
    )


# the reference's four setups: an ample paged pool, the chunked lane, a
# block-starved pool (11 usable blocks for 3 slots) and the contiguous layout
SETUPS = [
    ("paged-ample", dict(layout="paged", stall_patience=6)),
    ("paged-chunked", dict(layout="paged", prefill_chunk=BS, token_budget=BS, stall_patience=6)),
    ("paged-starved", dict(layout="paged", num_blocks=12, stall_patience=4, max_waiting=8)),
    ("contiguous", dict(stall_patience=6)),
]


@pytest.mark.recovery
def test_crash_restart_episode_matrix(smol, tmp_path):
    """Seeded kill-and-restore episodes over the four setups in turn; the
    oracle is the contiguous engine with the paged block size as its
    decode split."""
    cfg, params = smol
    oracle_eng = te.Engine(cfg, params, _scfg(), device="cpu")
    ccfg = chaos.ChaosConfig()
    reports = []
    n = recovery_episodes(2)
    for ep in range(n):
        name, kw = SETUPS[ep % len(SETUPS)]
        seed = chaos_seed() + chaos.SEED_STRIDE + ep
        reqs = chaos.make_chaos_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN, ccfg)
        oracle = chaos.oracle_outputs(oracle_eng, reqs)
        scfg = _scfg(snapshot_dir=str(tmp_path / f"ep{ep:03d}"), **kw)
        reports.append(chaos.run_crash_episode(
            cfg, params, scfg, oracle, reqs, seed, ccfg, device="cpu"))
    assert all(r.steps > 0 for r in reports)
    assert any(r.source in ("snapshot", "cold") for r in reports), (
        "no episode ever restored anything")
    assert sum(r.statuses.get("FINISHED", 0) for r in reports) > 0, (
        "no request ever survived a crash")
    if n >= 3:
        assert any(r.source == "snapshot" for r in reports), (
            "no episode restored from a snapshot")


@pytest.mark.recovery
@pytest.mark.parametrize("name,kw", SETUPS[2:], ids=[n for n, _ in SETUPS[2:]])
def test_crash_episode_corrupt_snapshot(smol, tmp_path, name, kw):
    """The two setups the default matrix does not reach, each once with the
    newest snapshot corrupted at the kill (when one was published): the
    restore quarantines it and still finishes bitwise."""
    cfg, params = smol
    oracle_eng = te.Engine(cfg, params, _scfg(), device="cpu")
    ccfg = chaos.ChaosConfig()
    seed = chaos_seed() + chaos.SEED_STRIDE + 7
    reqs = chaos.make_chaos_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN, ccfg)
    oracle = chaos.oracle_outputs(oracle_eng, reqs)
    rep = chaos.run_crash_episode(cfg, params, _scfg(snapshot_dir=str(tmp_path), **kw),
                                  oracle, reqs, seed, ccfg, p_corrupt=1.0, device="cpu")
    assert rep.corrupted == (rep.quarantined > 0)
    assert rep.steps > 0 and sum(rep.statuses.values()) == len(reqs)
