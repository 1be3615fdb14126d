"""The port's engine on its own: pool invariants, sampling, lifecycle,
the NaN guard, the watchdog, and no silent CPU fallback.

``smollm-360m-smoke`` in float32 with the port's own ``Model.init``; every
engine runs on the CPU, asked for explicitly, where the kernel wrappers
take their plain versions.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs import registry as treg
from repro_torch.serve import engine as te

ROOT = Path(__file__).resolve().parents[1]
BS, MAX_LEN, SLOTS = 16, 64, 3


@pytest.fixture(scope="module")
def smol():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return None, None, cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _shared_prefix_prompts(vocab, seed=1):
    """Two full blocks of shared prefix, extended differently; two
    requests repeat one prompt exactly (shared tail -> copy-on-write)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, 2 * BS + 5).astype(np.int32)
    tails = [rng.integers(0, vocab, n).astype(np.int32) for n in (0, 3, 0, 7)]
    prompts = [np.concatenate([pre, t]) for t in tails]
    prompts.append(rng.integers(0, vocab, 9).astype(np.int32))
    return prompts, [6, 5, 8, 4, 7]


def _requests(mod, prompts, budgets, **kw):
    return [
        mod.Request(p, max_new=b, request_id=i, **kw)
        for i, (p, b) in enumerate(zip(prompts, budgets))
    ]


def _scfgs(mod, layout, **kw):
    if layout == "paged":
        kv = mod.KVConfig(layout="paged", block_size=BS)
    else:
        kv = mod.KVConfig(decode_block=BS)
    return mod.ServeConfig(
        max_len=MAX_LEN,
        scheduler=mod.SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=kv, **kw,
    )


def _tokens(outs):
    return [o.tolist() for o in outs]


def test_paged_pool_invariants_every_step_and_equal_contiguous(smol, monkeypatch):
    _, _, cfg_t, tparams = smol
    copies = []
    real_copy = te.kvcache.paged_copy_block
    monkeypatch.setattr(
        te.kvcache, "paged_copy_block",
        lambda *a: copies.append(a[1:]) or real_copy(*a),
    )
    prompts, budgets = _shared_prefix_prompts(cfg_t.vocab, seed=2)
    paged = te.Engine(cfg_t, tparams, _scfgs(te, "paged"), device="cpu")
    rids = [paged.submit(r) for r in _requests(te, prompts, budgets)]
    while True:
        alive = paged.step()
        paged.pool.assert_invariants(paged.live_block_refs())
        if not alive:
            break
    assert copies, "the workload must exercise copy-on-write"
    assert paged.pool.free_blocks == paged.pool.num_blocks - 1
    got = [paged.pop_result(r).tolist() for r in rids]
    contig = te.Engine(cfg_t, tparams, _scfgs(te, "contiguous"), device="cpu")
    assert got == _tokens(contig.run(_requests(te, prompts, budgets)))


def test_temperature_batched_equals_solo(smol):
    _, _, cfg_t, tparams = smol
    prompts, budgets = _shared_prefix_prompts(cfg_t.vocab, seed=4)
    kw = dict(temperature=0.9, seed=11)
    batched = te.Engine(cfg_t, tparams, _scfgs(te, "contiguous", **kw), device="cpu")
    outs = _tokens(batched.run(_requests(te, prompts, budgets)))
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        solo = te.Engine(cfg_t, tparams, _scfgs(te, "contiguous", **kw), device="cpu")
        assert solo.run([te.Request(p, max_new=b, request_id=i)])[0].tolist() == outs[i]
    # and the noise really depends on the seed
    other = te.Engine(cfg_t, tparams, _scfgs(te, "contiguous", temperature=0.9, seed=12),
                      device="cpu")
    assert _tokens(other.run(_requests(te, prompts, budgets))) != outs


def test_lifecycle_cancel_reject_and_unported_fields(smol):
    _, _, cfg_t, tparams = smol
    scfg = te.ServeConfig(
        max_len=MAX_LEN, scheduler=te.SchedulerConfig(batch=1, max_waiting=1)
    )
    eng = te.Engine(cfg_t, tparams, scfg, device="cpu")
    a = eng.submit(te.Request(np.arange(5), max_new=6))
    b = eng.submit(te.Request(np.arange(4), max_new=3))
    assert eng.status(b) == te.RequestStatus.REJECTED
    eng.step()
    assert eng.status(a) == te.RequestStatus.ACTIVE
    assert eng.cancel(a) == te.RequestStatus.CANCELLED
    res = eng.pop_result(a)
    assert res.status == te.RequestStatus.CANCELLED and len(res) == 2
    assert eng.pop_result(a).status == te.RequestStatus.UNKNOWN
    # ported since (ROADMAP A7): ABFT and the per-block KV checksums
    assert te.KernelConfig(abft="checksum").abft == "checksum"
    assert te.DurabilityConfig(kv_checksum=True).kv_checksum
    # ported since (ROADMAP A5a-A5c): the lane, priorities and deadlines
    assert te.SchedulerConfig(prefill_chunk=8).prefill_chunk == 8
    for req in (te.Request(np.arange(3), priority=1), te.Request(np.arange(3), deadline_steps=4)):
        rid = eng.submit(req)  # max_waiting=1: one queued request at a time
        assert eng.status(rid) == te.RequestStatus.WAITING
        eng.cancel(rid)
    # crash recovery is still A8
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        te.DurabilityConfig(snapshot_dir="x")


def test_nan_guard_quarantines_only_the_poisoned_row(smol, monkeypatch):
    _, _, cfg_t, tparams = smol
    prompts, budgets = _shared_prefix_prompts(cfg_t.vocab, seed=5)
    clean = _tokens(te.Engine(cfg_t, tparams, _scfgs(te, "paged"), device="cpu").run(
        _requests(te, prompts[:3], budgets[:3])))
    eng = te.Engine(cfg_t, tparams, _scfgs(te, "paged"), device="cpu")
    real_step = eng.model.decode_step
    calls = []

    def poisoned(*a, **kw):
        logits, caches = real_step(*a, **kw)
        calls.append(1)
        if len(calls) == 2:  # the second decode step poisons slot 1
            logits[1] = float("nan")
        return logits, caches

    monkeypatch.setattr(
        eng, "model", types.SimpleNamespace(prefill=eng.model.prefill, decode_step=poisoned)
    )
    outs = eng.run(_requests(te, prompts[:3], budgets[:3]))
    assert [o.status for o in outs] == [
        te.RequestStatus.FINISHED, te.RequestStatus.FAILED, te.RequestStatus.FINISHED
    ]
    # the failed request keeps the tokens emitted before the bad step
    assert outs[1].tolist() == clean[1][:2]
    assert [outs[0].tolist(), outs[2].tolist()] == [clean[0], clean[2]]
    assert eng.stats["quarantined"] == 1
    eng.pool.assert_invariants(eng.live_block_refs())
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1


def test_watchdog_sheds_the_head_when_the_pool_is_held(smol):
    _, _, cfg_t, tparams = smol
    scfg = te.ServeConfig(
        max_len=MAX_LEN, scheduler=te.SchedulerConfig(batch=2, stall_patience=3),
        kv=te.KVConfig(layout="paged", block_size=BS),
    )
    eng = te.Engine(cfg_t, tparams, scfg, device="cpu")
    held = eng.pool.reserve(eng.pool.free_blocks)  # an external actor holds every block
    rid = eng.submit(te.Request(np.arange(20), max_new=4))
    steps = 0
    while eng.step():
        steps += 1
    assert steps == 2 and eng.status(rid) == te.RequestStatus.REJECTED
    assert "watchdog" in eng.pop_result(rid).reason and eng.stats["shed"] == 1
    eng.pool.assert_invariants(eng.live_block_refs())
    eng.pool.unreserve(held)
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def test_entry_points_raise_without_a_card(smol):
    """No silent CPU fallback: the default device is the card."""
    _, _, cfg_t, tparams = smol
    if torch.cuda.is_available():
        pytest.skip("a card is visible; this checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Engine(cfg_t, tparams, _scfgs(te, "contiguous"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.resolve_device(None)
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "1"],
        env=_no_card_env(), capture_output=True, text=True, timeout=120,
    )
    assert cli.returncode != 0 and "no CUDA device" in cli.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = _no_card_env()
    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
    assert '"ok": true' not in run.stdout
    # alone in a directory, without the program, it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    run = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0 and '"ok": true' not in run.stdout
