"""The port's training loop (``repro_torch.train.loop``), its step
functions (``launch/steps.py``) and launcher (``launch/train.py``) on the
CPU, on ``smollm-360m-smoke`` as the reference's ``tests/test_system.py``
drives its own.

Across frameworks the step's loss and gradient norm are compared, not the
parameters after it: at step 1 AdamW moves each parameter by about lr x
the sign of its gradient, so a gradient of order 1e-12 whose sign differs
between the two moves a parameter by 2 lr.  Within the port a restart is
expected to finish bit for bit as the uninterrupted run (every op here is
deterministic on the CPU), and microbatches 1 and 2 to agree within the
reference's own 5e-2.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch.model_zoo import build  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import StragglerMonitor, TrainConfig, make_train_step, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m-smoke"


def _small_cfgs(steps=14, ckpt_dir=None, microbatches=1):
    mcfg = get(ARCH)
    dcfg = DataConfig(vocab=mcfg.vocab, seq_len=16, global_batch=4)
    tcfg = TrainConfig(
        steps=steps, microbatches=microbatches, ckpt_every=5, ckpt_dir=ckpt_dir,
        opt=optim.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps),
    )
    return mcfg, dcfg, tcfg


def _tbatch(dcfg, step):
    return {k: torch.from_numpy(v) for k, v in batch_at(dcfg, step).items()}


def test_training_reduces_held_out_loss():
    """The reference's ``test_training_reduces_loss``: the mean loss over 16
    fixed never-trained-on batches falls over 30 steps."""
    steps = 30
    mcfg, dcfg, tcfg = _small_cfgs(steps=steps)
    model = build(mcfg)
    held = [_tbatch(dcfg, 10_000 + i) for i in range(16)]

    @torch.no_grad()
    def held_out_loss(params):
        return float(np.mean([float(model.loss(params, b["tokens"], b["labels"]))
                              for b in held]))

    before = held_out_loss(model.init(torch.Generator().manual_seed(0)))  # train()'s seed
    out = train(mcfg, dcfg, tcfg, device="cpu")
    assert len(out["losses"]) == steps and np.isfinite(out["losses"]).all()
    assert len(out["step_times"]) == steps
    after = held_out_loss(out["final_params"])
    assert after < before, f"no learning: held-out {before} -> {after}"


def test_microbatched_step_matches_plain():
    mcfg = get(ARCH)
    model = build(mcfg)
    dcfg = DataConfig(vocab=mcfg.vocab, seq_len=16, global_batch=4)
    batch = _tbatch(dcfg, 0)
    out = []
    for mb in (1, 2):
        params = model.init(torch.Generator().manual_seed(0))
        tcfg = TrainConfig(microbatches=mb, opt=optim.AdamWConfig(lr=1e-3))
        p, _, m = make_train_step(model, tcfg)(params, optim.init_state(params), batch)
        out.append((p, m))
    (p1, m1), (p2, m2) = out
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(optim.tree_leaves(p1), optim.tree_leaves(p2)))
    assert diff < 5e-2  # bf16 accumulation tolerance, the reference's
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=2e-2)


def test_checkpoint_restart_is_bitwise_the_straight_run(tmp_path):
    """Crash after 10 steps + resume to 14 == 14 uninterrupted steps (the
    data pipeline is a pure function of the step, the learning-rate
    schedule the same 14-step one): bit for bit on the CPU."""
    ckpt_dir = str(tmp_path / "ck")
    mcfg, dcfg, tcfg = _small_cfgs(steps=14, ckpt_dir=ckpt_dir)
    # the crashed run stops at step 10 on the 14-step schedule
    first = train(mcfg, dcfg, dataclasses.replace(tcfg, steps=10), device="cpu")
    assert len(first["save_times"]) == 2  # steps 5 and 10
    mcfg, dcfg, tcfg2 = _small_cfgs(steps=14, ckpt_dir=ckpt_dir)
    resumed = train(mcfg, dcfg, tcfg2, resume=True, device="cpu")
    assert len(resumed["losses"]) == 4
    mcfg, dcfg, tcfg3 = _small_cfgs(steps=14)
    straight = train(mcfg, dcfg, tcfg3, device="cpu")
    assert resumed["losses"] == straight["losses"][10:]
    for a, b in zip(optim.tree_leaves(resumed["final_params"]),
                    optim.tree_leaves(straight["final_params"])):
        assert torch.equal(a, b)


def test_straggler_detection():
    mon = StragglerMonitor(factor=3.0)
    for s in range(8):
        mon.record(s, 0.01)
    assert not mon.flagged
    assert mon.record(8, 0.2)  # 20x median
    assert mon.flagged and mon.flagged[0][0] == 8
    assert not mon.record(9, 0.011)


def test_train_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg, dcfg, tcfg = _small_cfgs(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(mcfg, dcfg, tcfg)


def test_launch_step_loss_and_grad_norm_match_reference():
    """One step of ``launch.steps.make_train_step`` on pre-shaped
    microbatches, fp32, same weights and batch: the loss and the gradient
    norm (both taken before the update) agree with the reference's."""
    cfg_j = dataclasses.replace(jreg.get(ARCH), dtype="float32")
    cfg_t = dataclasses.replace(get(ARCH), dtype="float32")
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    jp, tp = jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree)
    b = batch_at(DataConfig(vocab=cfg_t.vocab, seq_len=16, global_batch=4), 3)
    shaped = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    _, _, jm = jsteps.make_train_step(cfg_j, jopt.AdamWConfig(**kw))(
        jp, jopt.init_state(jp), {k: jnp.asarray(v) for k, v in shaped.items()})
    _, st, tm = tsteps.make_train_step(cfg_t, optim.AdamWConfig(**kw))(
        tp, optim.init_state(tp), {k: torch.from_numpy(v) for k, v in shaped.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert int(st["step"]) == 1


def test_prefill_and_decode_steps_run():
    cfg = get(ARCH)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_caches(2, 16)
    toks = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    logits, caches = tsteps.make_prefill_step(cfg)(params, {"tokens": toks}, caches)
    assert logits.shape == (2, cfg.vocab)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    logits2, _ = tsteps.make_decode_step(cfg)(params, nxt, caches)
    assert logits2.shape == (2, cfg.vocab) and torch.isfinite(logits2).all()


def test_launcher_trains_and_checkpoints_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "6",
         "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[0].startswith("step 0 loss ") and lines[1].startswith("step 5 loss ")
    assert lines[-1] == "done; stragglers: 0" or lines[-1].startswith("done; stragglers: ")
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
