"""Port parity: gemma3's local:global backbone, its window-sized ring
groups, their serving and their crash recovery.

``gemma3-12b-smoke`` has 7 layers: one group of 5 local layers at a
window of 8 and one global layer, then one local tail layer.  The same
weights (the reference's init, moved through the bridge, every matrix but
the embedding scaled by a gain so that the layers move the residual
stream) and the same seeded numpy inputs go through the reference and the
port.

Tolerances: fp32 to 1e-5 of the logits' scale; bf16 to 2e-2 of it.
Greedy tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.serve import engine as je  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import chaos, recovery  # noqa: E402
from repro_torch.serve import engine as te  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402

ARCH = "gemma3-12b-smoke"
REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=REL[dtype] * scale)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _model(dtype="float32", gain=8.0):
    cfg_j = dataclasses.replace(jreg.get(ARCH), dtype=dtype)
    cfg_t = dataclasses.replace(treg.get(ARCH), dtype=dtype)
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(0)))

    def f(path, a):
        key = str(path[-1])
        if a.ndim >= 2 and "scale" not in key and "tok" not in key:
            return (a * gain).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(f, tree)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, "cpu")


def test_caches_and_slot_axes_match_reference():
    """Window-sized local rings under (groups, local layers), max_len global
    caches under (groups,), the tail's rings; values, dtypes, slot axes."""
    cfg_j, cfg_t, _, _ = _model("bfloat16")
    want = _flat(jkv.build_caches(cfg_j, 3, 32))
    got = _flat(tkv.build_caches(cfg_t, 3, 32, "cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name, k
        assert np.array_equal(_np(got[k]), np.asarray(want[k]).astype(np.float32)), k
    assert got["/groups/local/k"].shape[:3] == (1, 5, 3)
    assert got["/groups/local/k"].shape[3] == cfg_t.sliding_window
    assert got["/groups/global/k"].shape[:3] == (1, 3, 32)
    assert got["/tail/k"].shape[:3] == (1, 3, cfg_t.sliding_window)
    assert tkv.slot_axes(cfg_t, 32) == jkv.slot_axes(cfg_j, 32)
    # whole groups and no tail: the reference's None subtree
    cj, ct = (dataclasses.replace(c, n_layers=12) for c in (cfg_j, cfg_t))
    assert tkv.build_caches(ct, 2, 16, "cpu")["tail"] is None
    assert tkv.slot_axes(ct, 16) == jkv.slot_axes(cj, 16)
    assert not tkv.supports_paged(cfg_t) and not tkv.supports_padded_prefill(cfg_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_through_the_ring_wrap(dtype):
    """A 20-token prompt (more than twice the window of 8: the reference's
    local rings keep the last 8 keys at prefill), then five decode steps,
    the last two through the decode kernel's plain version; logits and
    every cache leaf against the reference."""
    cfg_j, cfg_t, jp, tp = _model(dtype)
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_j.vocab, (3, 20)).astype(np.int32)
    jc, tc = jkv.build_caches(cfg_j, 3, 32), tkv.build_caches(cfg_t, 3, 32, "cpu")
    jl, jc = jprefill(jp, jnp.asarray(toks), jc)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tc)
    _close(tl, jl, dtype)
    for i in range(5):
        step = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)
        jd, jc = jdecode(jp, jnp.asarray(step), jc)
        disp = tL.Dispatch(attention="flash") if i >= 3 else tL.PLAIN
        td, tc = tm.decode_step(tp, torch.from_numpy(step), tc, dispatch=disp)
        _close(td, jd, dtype)
    flat_t = _flat(tc)
    for path, leaf in _flat(jc).items():
        if path.endswith(("/pos", "/len")):
            assert np.array_equal(flat_t[path].numpy(), np.asarray(leaf)), path
        else:
            _close(flat_t[path], leaf, dtype)
    assert int(tc["groups"]["local"]["len"].max()) == 25 > 3 * cfg_t.sliding_window


def test_without_caches_the_layer_windows_loop_gives_the_same_logits():
    """Without caches the backbone runs the per-layer window loop; its last
    logits equal the grouped ring path's prefill."""
    _, cfg_t, _, tp = _model()
    tm = tbuild(cfg_t)
    toks = torch.randint(0, cfg_t.vocab, (2, 6), generator=torch.Generator().manual_seed(3))
    want, _ = tm.prefill(tp, toks, tkv.build_caches(cfg_t, 2, 16, "cpu"))
    x = tL.embed(tp["embed"], toks)
    logits, _ = tm.logits_fn(tp, x, positions=torch.arange(6, dtype=torch.int32))
    _close(logits[:, -1], want, "float32")


def _requests(mod, vocab, lens, budgets, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, n).astype(np.int32), max_new=b, request_id=i)
            for i, (n, b) in enumerate(zip(lens, budgets))]


LENS, BUDGETS = [5, 20, 5, 12, 9], [7, 6, 9, 8, 6]


def test_greedy_tokens_equal_reference_engine():
    """fp32, weights x40, contiguous (paged is refused for local:global, as
    in the reference), three slots; every request passes the window of 8,
    the 20-token prompt already at prefill."""
    cfg_j, cfg_t, jp, tp = _model(gain=40.0)

    def scfg(mod):
        return mod.ServeConfig(max_len=48, scheduler=mod.SchedulerConfig(batch=3),
                               kernel=mod.KernelConfig(attention="flash"))

    want = je.Engine(cfg_j, jp, scfg(je)).run(_requests(je, cfg_j.vocab, LENS, BUDGETS))
    eng = te.Engine(cfg_t, tp, scfg(te), device="cpu")
    got = eng.run(_requests(te, cfg_t.vocab, LENS, BUDGETS))
    assert [o.status for o in got] == [te.RequestStatus.FINISHED] * len(LENS)
    assert [o.tolist() for o in got] == [o.tolist() for o in want]
    assert len({t for o in got for t in o.tolist()}) > len(LENS)
    for mod, params, cfg, kw in ((je, jp, cfg_j, {}), (te, tp, cfg_t, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.Engine(cfg, params, mod.ServeConfig(max_len=48, kv=mod.KVConfig(layout="paged")),
                       **kw)


def test_crash_restore_bitwise(tmp_path):
    """The grouped rings and global caches come back from a snapshot
    bitwise: killed after 6 steps (a snapshot at step 4, the journal after
    it), the restored engine finishes every request as the uninterrupted
    run, at temperature 0.8."""
    _, cfg_t, _, tp = _model(gain=40.0)
    base = te.ServeConfig(max_len=48, temperature=0.8, seed=5,
                          scheduler=te.SchedulerConfig(batch=3))
    reqs = _requests(te, cfg_t.vocab, LENS, BUDGETS)
    want = {r.request_id: o.tolist()
            for r, o in zip(reqs, te.Engine(cfg_t, tp, base, device="cpu").run(reqs))}
    scfg = dataclasses.replace(base, durability=te.DurabilityConfig(
        snapshot_dir=str(tmp_path), snapshot_every=4))
    eng = te.Engine(cfg_t, tp, scfg, device="cpu")
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    eng.recovery.wait()
    eng.recovery.journal._f.close()  # the simulated kill
    del eng
    eng2, report = recovery.restore_engine(cfg_t, tp, scfg, device="cpu")
    assert report.source == "snapshot" and report.snapshot_key == (0, 4)
    assert report.tokens_replayed > 0
    assert len(recovery.cache_leaves(eng2.caches)) == 12  # k, v, pos, len of 3 subtrees
    while eng2.step():
        chaos.audit(eng2)
    for r in reqs:
        assert eng2.pop_result(r.request_id).tolist() == want[r.request_id], r.request_id
    eng2.close()


def test_launcher_serves_gemma3_on_the_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                  "--new-tokens", "12", "--slots", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "statuses: FINISHED=3" in out
