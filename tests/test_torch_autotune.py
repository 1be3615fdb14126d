"""``ServeConfig.autotune`` and ``launch/serve.py --autotune`` on the port.

On the CPU (``smollm-360m-smoke`` in float32, the reference's weights
bridged to torch): an autotuned port engine serves, and its greedy tokens
equal those of the reference's Engine built from the same knobs -- the
port's plan priced for the H100, the reference's own plan on its TPU
description (the same knobs, bit for bit), and a plan over a narrowed
space (contiguous, 8-token splits, the prefill lane at 16-token chunks).
``from_plan_knobs`` maps knobs onto the nested sub-configs as the
reference does; the launcher plans, prints its ``[autotune]`` line, serves
the plan, hits the plan cache on a rerun and keeps the reference's usage
errors.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import registry as treg
from repro_torch.core import serveplan as tsp
from repro_torch.launch import serve as launcher
from repro_torch.serve import engine as te

MAX_LEN = 64
SPEC = [(5, 6), (37, 9), (3, 4), (23, 5), (58, 4), (12, 7)]  # (prompt, budget)
WORKLOAD = (3, 24, 6)  # (concurrency, prompt_len, decode_len)


def _reqs(mod, vocab):
    rng = np.random.default_rng(5)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=m, request_id=i)
            for i, (n, m) in enumerate(SPEC)]


NARROW = dict(layouts=("contiguous",), block_sizes=(8,), prefill_chunks=(16,))


@pytest.mark.parametrize("hardware,narrow", [("h100", False), ("tpu", False), ("h100", True)])
def test_autotuned_engine_tokens_equal_the_reference(tmp_path, hardware, narrow):
    jax = pytest.importorskip("jax")
    from repro.arch.model_zoo import build as jbuild
    from repro.configs import registry as jreg
    from repro.core import serveplan as rsp
    from repro.serve import engine as je
    from repro_torch import bridge

    cfg_j = dataclasses.replace(jreg.get("smollm-360m-smoke"), dtype="float32")
    cfg_t = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32")
    space = tsp.ServePlanSpace(**NARROW) if narrow else None
    hw = tsp.ServeHardware.tpu_v5e() if hardware == "tpu" else None
    scfg = te.ServeConfig.autotune(cfg_t, max_len=MAX_LEN, workload=tsp.ServeWorkload(*WORKLOAD),
                                   hardware=hw, space=space, cache=str(tmp_path / "plans.json"))
    plan = scfg.autotune_plan
    assert plan.source == "search" and plan.predicted["tokens_per_s"] > 0
    assert scfg.scheduler.batch == plan.knobs.slots
    if narrow:
        assert plan.knobs.kv_layout == "contiguous" and scfg.kv.decode_block == 8
        assert scfg.scheduler.prefill_chunk == 16
    if hardware == "tpu":
        want_plan = rsp.plan_serve(cfg_j, max_len=MAX_LEN, workload=rsp.ServeWorkload(*WORKLOAD),
                                   cache=False)
        assert want_plan.knobs.as_dict() == plan.knobs.as_dict()
    jscfg = je.ServeConfig.from_plan_knobs(rsp.ServeKnobs(**plan.knobs.as_dict()),
                                           max_len=MAX_LEN)
    jparams = jbuild(cfg_j).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = je.Engine(cfg_j, jparams, jscfg).run(_reqs(je, cfg_j.vocab))
    eng = te.Engine(cfg_t, tparams, scfg, device="cpu")
    got = eng.run(_reqs(te, cfg_t.vocab))
    assert [(o.status.value, o.tolist()) for o in got] == [
        (o.status.value, o.tolist()) for o in want]
    assert all(o.status == te.RequestStatus.FINISHED for o in got)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_from_plan_knobs_maps_as_the_reference(layout):
    knobs = tsp.ServeKnobs(slots=6, kv_layout=layout, block_size=32,
                           num_blocks=97 if layout == "paged" else None,
                           prefill_chunk=16, token_budget=32)
    kernel = te.KernelConfig(matmul="pallas")
    scfg = te.ServeConfig.from_plan_knobs(knobs, max_len=128, temperature=0.5, seed=3,
                                          kernel=kernel)
    assert (scfg.max_len, scfg.temperature, scfg.seed, scfg.kernel) == (128, 0.5, 3, kernel)
    sch = scfg.scheduler
    assert (sch.batch, sch.prefill_chunk, sch.token_budget) == (6, 16, 32)
    assert scfg.kv.layout == layout
    if layout == "paged":
        assert (scfg.kv.block_size, scfg.kv.num_blocks, scfg.kv.decode_block) == (32, 97, None)
    else:  # the planned block pins the contiguous decode split
        assert (scfg.kv.decode_block, scfg.kv.num_blocks) == (32, None)
    assert scfg.durability == te.DurabilityConfig()


def test_launcher_autotunes_serves_and_hits_the_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_SERVE_PLAN_CACHE", str(tmp_path / "plans.json"))
    argv = ["--device", "cpu", "--autotune", "--max-len", "64", "--requests", "3",
            "--new-tokens", "4", "--concurrency", "4"]
    launcher.main(argv)
    first = capsys.readouterr().out.splitlines()
    launcher.main(argv)
    second = capsys.readouterr().out.splitlines()
    assert first[0].startswith("[autotune] search: slots=")
    assert second[0] == first[0].replace("[autotune] search:", "[autotune] cache:")
    assert "statuses: FINISHED=3" in "\n".join(first)
    assert first[2:] == second[2:]  # the same tokens


@pytest.mark.parametrize("argv,msg", [
    (["--autotune", "--static"], "--autotune plans the continuous engine (drop --static)"),
    (["--resume"], "--resume requires --snapshot-dir"),
])
def test_launcher_usage_errors(argv, msg, capsys):
    with pytest.raises(SystemExit) as err:
        launcher.main(["--device", "cpu", *argv])
    assert err.value.code == 2
    assert msg in capsys.readouterr().err


def test_launcher_autotune_with_abft_plans_the_paged_pool(tmp_path, monkeypatch, capsys):
    """The SDC defense needs the paged pool, so ``--abft`` narrows the
    planned layouts to it (the reference plans both and can pick one its
    engine then refuses)."""
    monkeypatch.setenv("REPRO_TORCH_SERVE_PLAN_CACHE", str(tmp_path / "plans.json"))
    launcher.main(["--device", "cpu", "--autotune", "--abft", "checksum", "--max-len", "64",
                   "--requests", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "[autotune] search:" in out and "kv=paged/" in out
    assert "sdc_detected=0" in out and "statuses: FINISHED=2" in out
