"""Port parity: crash recovery against the reference's
(``repro.serve.recovery``).

One greedy workload with a preemption, a cancel and result pops goes
through a durable reference ``Engine`` and a durable port ``Engine``
step for step (``smollm-360m-smoke`` in float32, the reference's weights
moved through the bridge, the layers' projections scaled x50 so that the
greedy tokens vary, paged KV): the journals must hold the same
records in the same segments, each package's ``read_journal`` must read the
other's segments, and after a crash at the same step both packages'
restored engines must finish with the reference's uninterrupted greedy
tokens.  Pointed at the reference's snapshot directory, the port's
``restore_engine`` must either finish with those tokens too or refuse with
a ``ValueError`` that names the mismatch: it never loads silently wrong.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import recovery as jrec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import recovery as trec  # noqa: E402

BS, MAX_LEN, SLOTS = 8, 64, 3
CRASH_AT, PREEMPT_AT, CANCEL_AT = 7, 2, 4


@pytest.fixture(scope="module")
def smol():
    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    # at init the tied embedding dominates the residual stream and every
    # request repeats its last prompt token; x50 projections vary them
    layers = dict(jparams["layers"])
    for k in ("attn", "mlp"):
        layers[k] = jax.tree.map(lambda x: x * 50.0, layers[k])
    jparams = dict(jparams, layers=layers)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg_j, jparams, cfg_t, tparams


def _scfg(mod, snapshot_dir=None):
    return mod.ServeConfig(
        max_len=MAX_LEN,
        scheduler=mod.SchedulerConfig(batch=SLOTS, prefill_bucket=16),
        kv=mod.KVConfig(layout="paged", block_size=BS),
        durability=mod.DurabilityConfig(snapshot_dir=snapshot_dir, snapshot_every=3),
    )


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    pre = rng.integers(0, vocab, 2 * BS + 3).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, vocab, n).astype(np.int32)])
               for n in (0, 4, 0)]
    prompts += [rng.integers(0, vocab, n).astype(np.int32) for n in (9, 13, 5)]
    budgets = [9, 3, 7, 10, 6, 8]
    return [mod.Request(p, max_new=b, request_id=i) for i, (p, b) in
            enumerate(zip(prompts, budgets))]


def _engine(mod, cfg, params, scfg):
    if mod is te:
        return te.Engine(cfg, params, scfg, device="cpu")
    return je.Engine(cfg, params, scfg)


def _restore(mod, cfg, params, scfg, directory=None):
    if mod is te:
        return trec.restore_engine(cfg, params, scfg, directory, device="cpu")
    return jrec.restore_engine(cfg, params, scfg, directory)


def _drive_to_crash(mod, cfg, params, directory):
    """Submit the workload, preempt request 0 after step 2, cancel request 4
    after step 4, pop every terminal result after each step, and crash
    after step 7.  Returns the popped results."""
    eng = _engine(mod, cfg, params, _scfg(mod, directory))
    for r in _requests(mod, cfg.vocab):
        eng.submit(r)
    popped = {}
    for step in range(1, CRASH_AT + 1):
        eng.step()
        if step == PREEMPT_AT:
            assert eng.preempt(0)
        if step == CANCEL_AT:
            assert eng.cancel(4) == mod.RequestStatus.CANCELLED
        for rid in sorted(eng._reqs):
            if eng.status(rid) in mod.TERMINAL_STATUSES:
                popped[rid] = eng.pop_result(rid).tolist()
    assert eng.stats["preempted"] == 1 and popped
    eng.recovery.wait()
    eng.recovery.journal._f.close()  # the simulated kill
    return popped


def _segments(directory):
    return [os.path.join(directory, trec._wal_name(*k)) for k in trec._segment_keys(directory)]


@pytest.fixture(scope="module")
def crashed(smol, tmp_path_factory):
    """Both packages driven to the same crash, and the reference's
    uninterrupted greedy tokens."""
    cfg_j, jparams, cfg_t, tparams = smol
    want = {r.request_id: o.tolist() for r, o in zip(
        _requests(je, cfg_j.vocab),
        je.Engine(cfg_j, jparams, _scfg(je)).run(_requests(je, cfg_j.vocab)))}
    dirs = {}
    popped = {}
    for name, mod, cfg, params in (("ref", je, cfg_j, jparams), ("port", te, cfg_t, tparams)):
        dirs[name] = str(tmp_path_factory.mktemp(name))
        popped[name] = _drive_to_crash(mod, cfg, params, dirs[name])
    return want, dirs, popped


def test_journals_equal_record_for_record(crashed):
    _, dirs, popped = crashed
    assert popped["ref"] == popped["port"]
    ref, port = _segments(dirs["ref"]), _segments(dirs["port"])
    assert [os.path.basename(p) for p in ref] == [os.path.basename(p) for p in port]
    assert trec._snapshot_keys(dirs["ref"]) == trec._snapshot_keys(dirs["port"])
    kinds = set()
    for a, b in zip(ref, port):
        ra, torn_a = jrec.read_journal(a)
        rb, torn_b = trec.read_journal(b)
        assert (ra, torn_a) == (rb, torn_b), os.path.basename(a)
        kinds |= {r["t"] for r in ra}
        # each package reads the other's bytes the same way
        assert trec.read_journal(a) == (ra, torn_a)
        assert jrec.read_journal(b) == (rb, torn_b)
    assert kinds == {"submit", "tok", "cancel", "pop"}


@pytest.mark.parametrize("name", ["ref", "port"])
def test_both_packages_restore_to_the_reference_tokens(smol, crashed, name, tmp_path):
    cfg_j, jparams, cfg_t, tparams = smol
    want, dirs, popped = crashed
    mod, cfg, params = (je, cfg_j, jparams) if name == "ref" else (te, cfg_t, tparams)
    # restore from a copy: the other tests read the crashed directory too
    work = str(tmp_path / "snaps")
    shutil.copytree(dirs[name], work)
    eng, report = _restore(mod, cfg, params, _scfg(mod, work))
    assert report.source == "snapshot" and tuple(report.snapshot_key) == (0, 6)
    assert report.tokens_replayed > 0
    for rid in popped[name]:
        assert eng.status(rid) == mod.RequestStatus.UNKNOWN
    while eng.step():
        pass
    got = dict(popped[name])
    for rid in sorted(eng._reqs):
        got[rid] = eng.pop_result(rid).tolist()
    eng.close()
    for rid, toks in got.items():
        if rid == 4:  # cancelled: a prefix
            assert toks == want[rid][: len(toks)]
        else:
            assert toks == want[rid], rid


def test_port_restore_from_a_reference_snapshot(smol, crashed, tmp_path):
    """The reference's snapshot format 1 has the port's manifest keys and,
    for the paged smoke config, the same cache leaves: the port loads it
    and finishes with the reference's tokens, or refuses by name."""
    _, _, cfg_t, tparams = smol
    want, dirs, popped = crashed
    work = str(tmp_path / "snaps")
    shutil.copytree(dirs["ref"], work)
    try:
        eng, report = trec.restore_engine(cfg_t, tparams, _scfg(te, work), device="cpu")
    except ValueError as e:
        assert any(w in str(e) for w in ("ServeConfig", "cache leaf", "cache leaves")), e
        return
    assert report.source == "snapshot"
    while eng.step():
        pass
    for rid in sorted(eng._reqs):
        toks = eng.pop_result(rid).tolist()
        assert toks == (want[rid] if rid != 4 else want[rid][: len(toks)]), rid
    eng.close()
