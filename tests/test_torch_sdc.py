"""Port parity: the engine's silent-data-corruption (SDC) defense and the
seeded SDC episodes (``repro_torch.serve.chaos``).

Against the reference (``smollm-360m-smoke`` in float32, the reference's
weights moved through the bridge): the check-site counts of one step, the
greedy tokens of an ABFT engine, and the handling of one armed fault
(detected once, retried once, equal tokens after) must be the same in both
packages.  Within the port, after the reference's ``tests/test_sdc.py``:
ABFT-on tokens equal ABFT-off tokens, the seeded episode matrix reaches
100% detection with no false positive, leak-free drains and survivors
bitwise equal to their oracle, the retry budget quarantines repeat
offenders, and a weight flip raises before anything is emitted.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from conftest import sdc_episodes, sdc_seed  # noqa: E402
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch.model_zoo import build  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import abft  # noqa: E402
from repro_torch.serve import chaos  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402

MAX_LEN, BS = 64, 8


@pytest.fixture(scope="module")
def smol32():
    """The reference's fp32 smoke weights in both packages."""
    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg_j, jparams, cfg_t, tparams


@pytest.fixture(scope="module")
def smol():
    """The port's own bf16 smoke model, for the episodes."""
    cfg = treg.get("smollm-360m-smoke")
    return cfg, build(cfg).init(torch.Generator().manual_seed(0), "cpu")


def _paged(mod, abft_mode="off", matmul="xla", batch=3, **kernel):
    return mod.ServeConfig(
        max_len=MAX_LEN,
        scheduler=mod.SchedulerConfig(batch=batch, prefill_bucket=16),
        kv=mod.KVConfig(layout="paged", block_size=BS),
        kernel=mod.KernelConfig(matmul=matmul, abft=abft_mode, **kernel),
    )


def _requests(mod, vocab, n=5, seed=7):
    rng = np.random.default_rng(seed)
    return [
        mod.Request(rng.integers(0, vocab, int(rng.integers(4, 30))).astype(np.int32),
                    max_new=int(rng.integers(4, 9)), request_id=i)
        for i in range(n)
    ]


def _tokens(outs):
    return [o.tolist() for o in outs]


# --------------------------------------------------- against the reference --
@pytest.mark.parametrize("mode", ["checksum", "paranoid"])
def test_check_sites_equal_reference(smol32, mode):
    """One layer body plus the unembed: q, k, v, o, w_in, w_gate, w_out,
    unembed = 8 GEMM sites and 1 attention site, as the reference's scanned
    trace counts them."""
    cfg_j, jparams, cfg_t, tparams = smol32
    jeng = je.Engine(cfg_j, jparams, _paged(je, mode))
    teng = te.Engine(cfg_t, tparams, _paged(te, mode), device="cpu")
    for eng, mod in ((jeng, je), (teng, te)):
        eng.submit(_requests(mod, cfg_t.vocab, n=1)[0])
        eng.step()
        eng.step()
    assert teng._abft_probe == {"mms": 8, "attns": 1}
    assert teng._abft_probe == jeng._abft_probe
    jeng.close()


def test_abft_tokens_equal_reference_and_abft_off(smol32):
    """Greedy tokens: the port's ABFT engine (both matmul settings) serves
    the reference ABFT engine's tokens, and its own ABFT-off tokens."""
    cfg_j, jparams, cfg_t, tparams = smol32
    want = _tokens(je.Engine(cfg_j, jparams, _paged(je, "checksum")).run(
        _requests(je, cfg_j.vocab)))
    for matmul in ("xla", "pallas"):
        for mode in ("off", "checksum"):
            eng = te.Engine(cfg_t, tparams, _paged(te, mode, matmul), device="cpu")
            got = _tokens(eng.run(_requests(te, cfg_t.vocab)))
            assert got == want, (matmul, mode)
            assert eng.stats["sdc_detected"] == 0


@pytest.mark.parametrize("site,call_idx,layer", [
    (abft.FAULT_MATMUL, 7, abft.FAULT_OUTER),   # the unembed GEMM
    (abft.FAULT_MATMUL, 4, 1),                  # w_in of layer 1
    (abft.FAULT_ATTENTION, 0, 0),               # attention of layer 0
])
def test_armed_fault_detected_and_retried_like_reference(smol32, site, call_idx, layer):
    """The same armed fault (site, call, row 0, largest element, bit 27,
    layer) in both engines: one detection, one retry, and the tokens of an
    unfaulted run in both."""
    cfg_j, jparams, cfg_t, tparams = smol32
    results = []
    for mod, eng in (
        (je, je.Engine(cfg_j, jparams, _paged(je, "checksum"))),
        (te, te.Engine(cfg_t, tparams, _paged(te, "checksum", "pallas"), device="cpu")),
    ):
        reqs = _requests(mod, cfg_t.vocab, n=3)
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.step()
        eng.arm_fault(site, call_idx, 0, -1, 27, layer)
        while eng.step():
            pass
        results.append((eng.stats["sdc_detected"], eng.stats["sdc_retried"],
                        [eng.pop_result(r.request_id).tolist() for r in reqs]))
    assert results[0][:2] == results[1][:2] == (1, 1)
    assert results[0][2] == results[1][2]
    clean = te.Engine(cfg_t, tparams, _paged(te), device="cpu")
    assert _tokens(clean.run(_requests(te, cfg_t.vocab, n=3))) == results[1][2]


# ------------------------------------------------------- seeded episodes --
def _sdc_pair(cfg, params, mode, **kernel_extra):
    common = dict(max_len=MAX_LEN, temperature=0.7, seed=5)
    eng = te.Engine(cfg, params, te.ServeConfig(
        scheduler=te.SchedulerConfig(batch=3, prefill_bucket=16, stall_patience=6),
        kv=te.KVConfig(layout="paged", block_size=BS),
        kernel=te.KernelConfig(abft=mode, **kernel_extra), **common,
    ), device="cpu")
    oracle_eng = te.Engine(cfg, params, te.ServeConfig(
        scheduler=te.SchedulerConfig(batch=3, prefill_bucket=16),
        kv=te.KVConfig(decode_block=BS), **common,
    ), device="cpu")
    return eng, oracle_eng


@pytest.mark.sdc
def test_sdc_episode_matrix(smol):
    """Seeded bit-flip episodes across both abft modes; the fault mix
    cycles deterministically so every surface (compute flip, KV flip,
    mixed, clean) fires whatever the episode count."""
    cfg, params = smol
    setups = [("checksum", *_sdc_pair(cfg, params, "checksum")),
              ("paranoid", *_sdc_pair(cfg, params, "paranoid"))]
    mixes = [(1, 1), (2, 1), (1, 2), (0, 1), (2, 0), (1, 1)]
    reports = []
    for ep in range(sdc_episodes(4)):
        mode, eng, oracle_eng = setups[ep % len(setups)]
        n_compute, n_kv = mixes[ep % len(mixes)]
        seed = sdc_seed() + chaos.SEED_STRIDE + ep
        reqs = chaos.make_sdc_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN)
        oracle = chaos.oracle_outputs(oracle_eng, reqs)
        reports.append(chaos.run_sdc_episode(
            eng, oracle, reqs, seed, n_compute=n_compute, n_kv=n_kv))
    fired_compute = sum(r.injected["compute"] for r in reports)
    fired_kv = sum(r.injected["kv"] for r in reports)
    assert fired_compute > 0, "no compute fault ever fired"
    assert fired_kv > 0, "no KV flip ever fired"
    assert sum(r.detected for r in reports) == fired_compute
    assert sum(r.quarantined for r in reports) == fired_kv
    assert sum(r.statuses.get("FINISHED", 0) for r in reports) > 0


@pytest.mark.sdc
def test_sdc_clean_episode_zero_false_positives(smol):
    cfg, params = smol
    eng, oracle_eng = _sdc_pair(cfg, params, "checksum")
    seed = sdc_seed() + chaos.SEED_STRIDE + 777
    reqs = chaos.make_sdc_workload(np.random.default_rng(seed), cfg.vocab, MAX_LEN)
    oracle = chaos.oracle_outputs(oracle_eng, reqs)
    rep = chaos.run_sdc_episode(eng, oracle, reqs, seed, n_compute=0, n_kv=0)
    assert rep.detected == 0 and rep.retried == 0 and rep.quarantined == 0
    assert rep.statuses == {"FINISHED": len(reqs)}


@pytest.mark.sdc
def test_sdc_retry_budget_exhaustion_quarantines(smol):
    """A step-level checksum cannot name its victim, so each detection
    charges every live slot; the (SDC_RETRY_BUDGET+1)-th quarantines the
    survivors instead of retrying forever."""
    cfg, params = smol
    eng, oracle_eng = _sdc_pair(cfg, params, "checksum")
    rng = np.random.default_rng(99)
    reqs = [te.Request(rng.integers(0, cfg.vocab, 12).astype(np.int32), max_new=24,
                       request_id=i) for i in range(2)]
    oracle = chaos.oracle_outputs(oracle_eng, reqs)
    for r in reqs:
        eng.submit(r)
    eng.step()  # admit + learn the check sites
    n_mm = eng._abft_probe["mms"]
    for _ in range(te.SDC_RETRY_BUDGET + 1):
        assert eng._slots, "victims finished before the budget ran out"
        eng.arm_fault(abft.FAULT_MATMUL, n_mm - 1, 0, -1, 27)
        eng.step()
        chaos.audit(eng)
        eng.step()  # one clean step between hits
        chaos.audit(eng)
    assert eng.stats["sdc_detected"] == te.SDC_RETRY_BUDGET + 1
    assert eng.stats["sdc_retried"] == te.SDC_RETRY_BUDGET + 1
    assert eng.stats["quarantined"] == len(reqs)
    while eng.step():
        chaos.audit(eng)
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1
    for r in reqs:
        res = eng.pop_result(r.request_id)
        assert res.status == te.RequestStatus.FAILED
        assert res.reason == "sdc: retry budget exhausted"
        assert res.tolist() == oracle[r.request_id][: len(res)]


@pytest.mark.sdc
def test_sdc_weight_corruption_raises_before_emission(smol):
    """Weight rot cannot be localized (both sides of the checksum identity
    use the corrupt operand): the weight fingerprint raises
    SDCUnlocalizedError before the step emits anything (the restore that
    follows is the next test's)."""
    cfg, params = smol
    eng, oracle_eng = _sdc_pair(cfg, params, "checksum")
    rng = np.random.default_rng(41)
    reqs = [te.Request(rng.integers(0, cfg.vocab, 10).astype(np.int32), max_new=16,
                       request_id=i) for i in range(3)]
    oracle = chaos.oracle_outputs(oracle_eng, reqs)
    emitted = []
    for r in reqs:
        eng.submit(r)
    for _ in range(5):
        eng.step(on_token=lambda *a: emitted.append(a))
        chaos.audit(eng)
    assert eng._slots, "workload drained before the flip landed"
    before = list(emitted)
    eng.params, _leaf = chaos.flip_weight_bit(eng.params, rng)
    with pytest.raises(te.SDCUnlocalizedError, match="weight fingerprint"):
        eng.step(on_token=lambda *a: emitted.append(a))
    assert emitted == before
    assert eng.stats["sdc_detected"] == 1
    for r in reqs:  # everything emitted before the flip is the oracle's
        got = eng.pop_result(r.request_id).tolist()
        assert got == oracle[r.request_id][: len(got)]


@pytest.mark.sdc
def test_sdc_weight_corruption_raises_then_restores(smol, tmp_path):
    """After the reference's test of the same name: the weight fingerprint
    raises before the poisoned step emits or journals anything, and
    restoring from the newest snapshot with the pristine params finishes
    every request bitwise its ABFT-off oracle."""
    from repro_torch.serve import recovery

    cfg, params = smol
    _, oracle_eng = _sdc_pair(cfg, params, "checksum")
    scfg = te.ServeConfig(
        max_len=MAX_LEN, temperature=0.7, seed=5,
        scheduler=te.SchedulerConfig(batch=3, prefill_bucket=16),
        kv=te.KVConfig(layout="paged", block_size=BS),
        kernel=te.KernelConfig(abft="checksum"),
        durability=te.DurabilityConfig(
            snapshot_dir=str(tmp_path / "snaps"), snapshot_every=2, snapshot_keep=2),
    )
    rng = np.random.default_rng(41)
    reqs = [te.Request(rng.integers(0, cfg.vocab, 10).astype(np.int32), max_new=16,
                       request_id=i) for i in range(3)]
    oracle = chaos.oracle_outputs(oracle_eng, reqs)
    eng = te.Engine(cfg, params, scfg, device="cpu")
    for r in reqs:
        eng.submit(r)
    for _ in range(5):  # past snapshot_every: a snapshot has published
        eng.step()
        chaos.audit(eng)
    assert eng._slots, "workload drained before the flip landed"
    eng.params, _leaf = chaos.flip_weight_bit(eng.params, rng)
    with pytest.raises(te.SDCUnlocalizedError, match="weight fingerprint"):
        eng.step()
    assert eng.stats["sdc_detected"] == 1
    # the operator's response: abandon the poisoned process (the journal's
    # bytes survive, its fd is dropped) and restore with pristine params
    eng.recovery.wait()
    eng.recovery.journal._f.close()
    del eng
    eng2, report = recovery.restore_engine(cfg, params, scfg, device="cpu")
    chaos.audit(eng2)
    assert report.source == "snapshot"
    while eng2.step():
        chaos.audit(eng2)
    assert eng2.stats["sdc_detected"] == 0
    assert eng2.pool.free_blocks == eng2.pool.num_blocks - 1
    for r in reqs:
        res = eng2.pop_result(r.request_id)
        assert res.status == te.RequestStatus.FINISHED, (r.request_id, res.reason)
        assert res.tolist() == oracle[r.request_id], (
            f"rid {r.request_id} diverged after the weight-corruption restore")
    eng2.close()


@pytest.mark.sdc
def test_weight_scrub_cadence_catches_flip_within_period(smol):
    """At ``scrub_every=N`` the weight pass runs every N-th step only: a
    flip landing between scrubs still raises within N steps."""
    cfg, params = smol
    scrub = 3
    eng, _ = _sdc_pair(cfg, params, "checksum", scrub_every=scrub)
    rng = np.random.default_rng(4242)
    for i in range(2):
        eng.submit(te.Request(rng.integers(0, cfg.vocab, 10).astype(np.int32), max_new=40,
                              request_id=i))
    eng.step()
    eng.params, _leaf = chaos.flip_weight_bit(eng.params, rng)
    steps = 0
    with pytest.raises(te.SDCUnlocalizedError):
        for _ in range(2 * scrub):
            steps += 1
            eng.step()
    assert steps <= scrub, f"weight flip took {steps} steps to surface at scrub_every={scrub}"


def test_kv_checksum_quarantines_the_owner_without_abft(smol):
    """``kv_checksum`` alone: a block changed between steps FAILs the
    request holding it (no "sdc" prefix), the other request finishes."""
    cfg, params = smol
    scfg = te.ServeConfig(
        max_len=MAX_LEN, scheduler=te.SchedulerConfig(batch=2),
        kv=te.KVConfig(layout="paged", block_size=BS),
        durability=te.DurabilityConfig(kv_checksum=True),
    )
    eng = te.Engine(cfg, params, scfg, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(2):
        eng.submit(te.Request(rng.integers(0, cfg.vocab, 20).astype(np.int32), max_new=10,
                              request_id=i))
    eng.step()
    eng.step()
    victim, block = chaos.flip_kv_bit(eng, np.random.default_rng(0))
    while eng.step():
        chaos.audit(eng)
    assert eng.stats["quarantined"] == 1
    res = {i: eng.pop_result(i) for i in range(2)}
    assert res[victim].status == te.RequestStatus.FAILED
    assert res[victim].reason == f"KV corruption: block {block} checksum changed without a write"
    assert res[1 - victim].status == te.RequestStatus.FINISHED


# ------------------------------------------------------------ guardrails --
def test_arm_fault_requires_abft(smol):
    cfg, params = smol
    eng = te.Engine(cfg, params, _paged(te), device="cpu")
    with pytest.raises(ValueError, match="abft"):
        eng.arm_fault(abft.FAULT_MATMUL, 0, 0, -1, 27)


@pytest.mark.parametrize("make,match", [
    (lambda: te.ServeConfig(kernel=te.KernelConfig(abft="checksum"), max_len=MAX_LEN), "paged"),
    (lambda: te.ServeConfig(durability=te.DurabilityConfig(kv_checksum=True)), "paged"),
    (lambda: te.KernelConfig(abft="extra-paranoid"), "abft"),
    (lambda: te.KernelConfig(scrub_every=0), "scrub_every"),
])
def test_sdc_config_validated(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_launcher_abft_flags(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--abft", "paranoid", "--scrub-every", "2",
                "--kv-layout", "paged", "--requests", "2", "--new-tokens", "4",
                "--max-len", "32"])
    out = capsys.readouterr().out
    assert "abft=paranoid: sdc_detected=0 sdc_retried=0 quarantined=0" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--abft", "checksum"])
