"""Crash recovery on the port (``repro_torch.serve.recovery``), after the
reference's ``tests/test_recovery.py``: the journal, snapshot and restore,
quarantine of a corrupt snapshot, chained crashes, and the launcher's
``--snapshot-dir``/``--resume``.

The contract under test: a restored engine's requests finish with tokens
**bitwise equal** to a never-crashed run of the same config, whether the
restore came from a snapshot plus the journal after it, from the journal
alone, or from an older snapshot after the newest was quarantined.
``smollm-360m-smoke`` in float32 (rwkv6- and recurrentgemma-smoke in
their bf16) with the port's own weights, on the CPU, where the kernel
wrappers take their plain versions.  A simulated crash abandons the
engine without closing it: only what the journal already synced survives.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

from repro_torch.arch.model_zoo import build
from repro_torch.ckpt import checkpoint
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as launch
from repro_torch.serve import chaos, kvcache, recovery
from repro_torch.serve import engine as te

MAX_LEN, BS = 64, 8


@pytest.fixture(scope="module")
def smol():
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _workload(cfg, n=4, seed=1, budget=10):
    rng = np.random.default_rng(seed)
    return [
        te.Request(rng.integers(0, cfg.vocab, int(rng.integers(6, 20))).astype(np.int32),
                   budget, request_id=i)
        for i in range(n)
    ]


def _scfg(layout="paged", snapshot_dir=None, snapshot_every=32, batch=4, **sched):
    kv = (te.KVConfig(layout="paged", block_size=BS) if layout == "paged"
          else te.KVConfig(decode_block=BS))
    return te.ServeConfig(
        max_len=MAX_LEN, temperature=0.8, seed=3,
        scheduler=te.SchedulerConfig(batch=batch, **sched), kv=kv,
        durability=te.DurabilityConfig(snapshot_dir=snapshot_dir,
                                       snapshot_every=snapshot_every),
    )


def _engine(cfg, params, scfg):
    return te.Engine(cfg, params, scfg, device="cpu")


def _restore(cfg, params, scfg):
    return recovery.restore_engine(cfg, params, scfg, device="cpu")


def _oracle(cfg, params, scfg, reqs):
    """The never-crashed tokens every restore is held to."""
    bare = dataclasses.replace(
        scfg, durability=dataclasses.replace(scfg.durability, snapshot_dir=None))
    outs = _engine(cfg, params, bare).run(list(reqs))
    assert all(o.status == te.RequestStatus.FINISHED for o in outs)
    return {r.request_id: o.tolist() for r, o in zip(reqs, outs)}


@pytest.fixture(scope="module")
def paged_oracle(smol):
    cfg, params = smol
    reqs = _workload(cfg)
    return reqs, _oracle(cfg, params, _scfg(), reqs)


def _crash(eng):
    """Simulated SIGKILL: the snapshot in flight publishes (its daemon
    thread shares the process), the journal's fd is dropped unflushed."""
    eng.recovery.wait()
    eng.recovery.journal._f.close()


def _drain_bitwise(eng, reqs, want):
    while eng.step():
        chaos.audit(eng)
    for r in reqs:
        res = eng.pop_result(r.request_id)
        assert res.status == te.RequestStatus.FINISHED, (r.request_id, res)
        assert res.tolist() == want[r.request_id], (r.request_id, res.tolist())
    if eng.pool is not None:
        assert eng.pool.free_blocks == eng.pool.num_blocks - 1, "block leak"


# ------------------------------------------------------------ journal unit --


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "wal_0000_00000000.jsonl")
    j = recovery.Journal(path)
    recs = [{"t": "submit", "rid": 1}, {"t": "tok", "rid": 1, "toks": [3, 4]}]
    for r in recs:
        j.append(r)
    j.close()
    assert recovery.read_journal(path) == (recs, 0)
    with open(path, "rb") as f:
        first = f.read().split(b"\n")[0]
    body = b'{"t":"submit","rid":1}'
    assert first == b"%08x %s" % (zlib.crc32(body), body)
    # crash mid-append: a half-written final line is detected and dropped
    with open(path, "ab") as f:
        f.write(b'001a2b3c {"t":"tok","rid"')
    assert recovery.read_journal(path) == (recs, 1)


def test_journal_crc_rejects_bitflip_and_everything_after(tmp_path):
    path = str(tmp_path / "wal_0000_00000000.jsonl")
    j = recovery.Journal(path)
    for i in range(3):
        j.append({"t": "tok", "rid": i, "toks": [i]})
    j.close()
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    body = bytearray(lines[1])
    body[-2] ^= 1  # bit rot inside record 1's JSON
    lines[1] = bytes(body)
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))
    recs, torn = recovery.read_journal(path)
    # record 0 survives; the flipped record and the valid one after it go
    assert [r["rid"] for r in recs] == [0]
    assert torn == 1


def test_block_pool_state_roundtrip():
    pool = kvcache.BlockPool(12, 4)
    a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
    pool.register(-1, (1, 2, 3, 4), a)
    pool.register(a, (5, 6), b)
    pool.retain(a)
    held = pool.reserve(2)
    state = pool.to_state()
    back = kvcache.BlockPool.from_state(json.loads(json.dumps(state)))
    assert back.to_state() == state
    assert back._keys_of == pool._keys_of and back.index == pool.index
    assert back.match_prefix([1, 2, 3, 4, 5, 6]) == ([a], b)
    back.assert_invariants({a: 2, b: 1, c: 1})
    back.unreserve(held)
    assert back.free_blocks == pool.free_blocks + 2


# ----------------------------------------------------------- tensor leaves --


def test_bf16_leaf_roundtrip_bit_for_bit(tmp_path):
    """npz has no bfloat16: the bits go as uint16 and the manifest names
    the dtype as the reference does; every pattern comes back, NaNs and
    infinities included."""
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    t = bits.view(torch.bfloat16).reshape(256, 256)
    arr = checkpoint._to_savable(t)
    assert arr.dtype == np.uint16 and checkpoint.dtype_name(t.dtype) == "bfloat16"
    np.savez(tmp_path / "x.npz", x=arr)
    with np.load(tmp_path / "x.npz") as data:
        back = checkpoint._from_savable(data["x"], "bfloat16")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    f32 = torch.randn(5, 7)
    assert torch.equal(checkpoint._from_savable(checkpoint._to_savable(f32), "float32"), f32)


def test_staged_snapshot_is_not_aliased_by_later_steps(smol, tmp_path):
    """On the CPU ``t.cpu().numpy()`` shares the cache's memory, and the
    engine writes its caches in place: a snapshot staged at step N, then
    written after more steps, must still hold step N's bits and the sha
    of them."""
    cfg, params = smol
    eng = _engine(cfg, params, _scfg())
    for r in _workload(cfg):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    staged = recovery._stage(eng)
    want = {k: v.copy() for k, v in staged["arrays"].items()}
    kpool_before = eng.caches["kpool"].clone()
    for _ in range(3):
        eng.step()
    assert not torch.equal(eng.caches["kpool"], kpool_before), "steps wrote no KV"
    path = recovery._write_snapshot(str(tmp_path), recovery._snap_name(0, 2), staged, keep=3)
    snap = recovery._load_snapshot(str(tmp_path), (0, 2))
    assert os.path.basename(path) == "snap_0000_00000002"
    for k, v in want.items():
        got = snap["arrays"][k]
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        assert np.array_equal(got.numpy().view(v.dtype), v), k
    leaves = recovery.cache_leaves(eng.caches)
    names = sorted(eng.caches)
    assert [id(x) for x in leaves] == [id(eng.caches[k]) for k in names]
    assert torch.equal(snap["arrays"][f"cache_{names.index('kpool'):04d}"], kpool_before)


# ------------------------------------------------------- restore, bitwise --


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_snapshot_restore_replays_bitwise(smol, tmp_path, layout):
    cfg, params = smol
    reqs = _workload(cfg)
    scfg = _scfg(layout, snapshot_dir=str(tmp_path), snapshot_every=4)
    want = _oracle(cfg, params, scfg, reqs)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    held = eng.pool.reserve(2) if eng.pool is not None else None  # a co-tenant's hold
    eng.step()
    _crash(eng)
    eng2, report = _restore(cfg, params, scfg)
    assert report.source == "snapshot" and report.snapshot_key == (0, 4)
    assert report.tokens_replayed > 0 and report.torn_lines == 0
    assert recovery.replay_lag(eng2) > 0
    if held:
        # the reserve holder died with the process: restore released it
        assert eng2.pool.external == set()
    chaos.audit(eng2)
    _drain_bitwise(eng2, reqs, want)
    assert recovery.replay_lag(eng2) == 0
    assert eng2.stats["replayed"] > 0 and eng2.stats["snapshots"] >= 1
    eng2.close()


def test_cold_journal_replay_and_popped_not_resurrected(smol, paged_oracle, tmp_path):
    """A crash before the first snapshot: recovery is a journal replay
    through fresh prefills and teacher forcing.  A result the client
    popped before the crash must not come back."""
    cfg, params = smol
    reqs, want = paged_oracle
    scfg = _scfg(snapshot_dir=str(tmp_path), snapshot_every=10_000)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    while eng.step():
        pass
    assert eng.pop_result(0).status == te.RequestStatus.FINISHED
    eng2, report = _restore(cfg, params, scfg)
    assert report.source == "cold" and report.snapshot_key is None
    assert report.pops == 1 and report.resubmitted == len(reqs)
    assert eng2.status(0) == te.RequestStatus.UNKNOWN, "popped result came back"
    chaos.audit(eng2)
    _drain_bitwise(eng2, reqs[1:], want)
    eng2.close()


def test_corrupt_snapshot_quarantined_older_one_used(smol, paged_oracle, tmp_path):
    cfg, params = smol
    reqs, want = paged_oracle
    scfg = _scfg(snapshot_dir=str(tmp_path), snapshot_every=2)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    for _ in range(7):
        eng.step()
    eng.recovery.wait()
    keys = recovery._snapshot_keys(str(tmp_path))
    assert len(keys) >= 2
    assert chaos.corrupt_newest_snapshot(str(tmp_path))
    eng2, report = _restore(cfg, params, scfg)
    assert report.quarantined, "corrupt snapshot was not quarantined"
    assert report.source == "snapshot" and report.snapshot_key == keys[-2]
    assert any(n.endswith(".corrupt") for n in os.listdir(tmp_path)), (
        "the quarantined snapshot stays on disk for forensics")
    chaos.audit(eng2)
    _drain_bitwise(eng2, reqs, want)
    eng2.close()


def test_chained_crash_restores_bitwise(smol, paged_oracle, tmp_path):
    """Crash, restore, crash again mid-replay, restore again: the second
    generation's anchor snapshot makes the chain self-contained."""
    cfg, params = smol
    reqs, want = paged_oracle
    scfg = _scfg(snapshot_dir=str(tmp_path), snapshot_every=3)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    _crash(eng)
    eng2, rep2 = _restore(cfg, params, scfg)
    for _ in range(3):
        eng2.step()
    _crash(eng2)
    eng3, rep3 = _restore(cfg, params, scfg)
    assert rep3.source == "snapshot"
    assert rep3.snapshot_key[0] > (rep2.snapshot_key or (0, 0))[0], (
        "the second restore comes from the restored engine's generation")
    chaos.audit(eng3)
    _drain_bitwise(eng3, reqs, want)
    eng3.close()


def test_incompatible_config_rejected(smol, tmp_path):
    cfg, params = smol
    scfg = _scfg(snapshot_dir=str(tmp_path), snapshot_every=2)
    eng = _engine(cfg, params, scfg)
    for r in _workload(cfg, n=2):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.close()
    with pytest.raises(ValueError, match="seed"):
        _restore(cfg, params, dataclasses.replace(scfg, seed=scfg.seed + 1))
    contiguous = _scfg("contiguous", snapshot_dir=str(tmp_path), snapshot_every=2)
    with pytest.raises(ValueError, match="kv_layout"):
        _restore(cfg, params, contiguous)


def test_crash_mid_lane_restores_bitwise(smol, tmp_path):
    """A snapshot taken while a chunked-prefill lane is in flight stores
    the lane's request requeued (no token published, its blocks released
    in the stored pool image): restore re-prefills it from scratch and its
    tokens equal a never-crashed run's."""
    cfg, params = smol
    reqs = [te.Request(p, 5, request_id=i) for i, p in enumerate(
        np.random.default_rng(7).integers(0, cfg.vocab, (3, 40)).astype(np.int32))]
    scfg = _scfg(snapshot_dir=str(tmp_path), snapshot_every=1, batch=2,
                 prefill_chunk=BS, token_budget=BS)
    want = _oracle(cfg, params, scfg, reqs)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    # 40-token prompts at an 8-token budget take 5 steps a lane: two steps
    # in, a lane is mid-flight
    eng.step()
    eng.step()
    assert eng._lane is not None, "expected a mid-flight prefill lane"
    mid_rid = eng._lane.rid
    _crash(eng)
    eng2, _ = _restore(cfg, params, scfg)
    chaos.audit(eng2)
    assert eng2._lane is None
    assert eng2.status(mid_rid) == te.RequestStatus.WAITING
    assert len(eng2._outputs[mid_rid]) == 0
    _drain_bitwise(eng2, reqs, want)
    eng2.close()


# ------------------------------------------------------ recurrent families --


def _recurrent_params(cfg):
    """The port's init with the decays spread (init's are constant, or
    forget everything each step), from a seeded generator."""
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    if cfg.mixer == "rwkv6":
        wkv = params["layers"]["wkv"]
        wkv["w_lora_b"].copy_(torch.randn(wkv["w_lora_b"].shape, generator=g))
        wkv["w0"].uniform_(-6.0, -1.0, generator=g)
    else:
        for tree in (params["groups"]["rnn"], params["tail"]):
            if tree:
                tree["rnn"]["lam"].uniform_(-9.0, -2.0, generator=g)
    return params


@pytest.mark.parametrize("arch", ["rwkv6-1.6b-smoke", "recurrentgemma-2b-smoke"])
def test_recurrent_families_restore_bitwise(tmp_path, arch):
    """Recurrent states, token-shift rows and (recurrentgemma) window-sized
    KV rings come back bitwise: the two long requests' rings have wrapped
    by the crash (window 8), and every request finishes as uninterrupted."""
    cfg = treg.get(arch)
    params = _recurrent_params(cfg)
    rng = np.random.default_rng(5)
    lens = [20, 14, 5, 9, 12]
    reqs = [te.Request(rng.integers(0, cfg.vocab, n).astype(np.int32), 8, request_id=i)
            for i, n in enumerate(lens)]
    scfg = te.ServeConfig(
        max_len=MAX_LEN, scheduler=te.SchedulerConfig(batch=3),
        durability=te.DurabilityConfig(snapshot_dir=str(tmp_path), snapshot_every=3),
    )
    want = _oracle(cfg, params, scfg, reqs)
    eng = _engine(cfg, params, scfg)
    for r in reqs:
        eng.submit(r)
    for _ in range(5):
        eng.step()
    _crash(eng)
    eng2, report = _restore(cfg, params, scfg)
    assert report.source == "snapshot" and report.snapshot_key == (0, 3)
    assert report.tokens_replayed > 0
    _drain_bitwise(eng2, reqs, want)
    assert eng2.stats["replayed"] > 0
    eng2.close()


# --------------------------------------------------------------- launcher --


def test_launcher_snapshot_dir_and_resume(tmp_path, capsys):
    snap = str(tmp_path / "snaps")
    common = ["--device", "cpu", "--requests", "3", "--new-tokens", "6", "--max-len", "64"]
    launch.main(common + ["--snapshot-dir", snap, "--snapshot-every", "2"])
    first = capsys.readouterr().out
    assert "statuses: FINISHED=3" in first
    assert recovery._snapshot_keys(snap), "no snapshot was published"
    launch.main(common + ["--snapshot-dir", snap, "--resume"])
    out = capsys.readouterr().out
    # everything was popped before the restart: nothing to finish
    assert "[resume] source=snapshot" in out and "pops=" in out
    assert "served 0 requests" in out
    for bad in (["--resume"], ["--static", "--snapshot-dir", snap]):
        with pytest.raises(SystemExit):
            launch.main(common + bad)


def test_static_engine_refuses_snapshot_dir(smol, tmp_path):
    cfg, params = smol
    scfg = _scfg("contiguous", snapshot_dir=str(tmp_path))
    with pytest.raises(ValueError, match="snapshot_dir"):
        te.StaticEngine(cfg, params, scfg, device="cpu")
    with te.Engine(cfg, params, scfg, device="cpu") as eng:  # the continuous one takes it
        assert eng.recovery is not None and eng.recovery.gen == 0
    assert eng.recovery is None
