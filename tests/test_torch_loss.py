"""Port parity: the training loss and its gradients (``Model.loss``,
``EncDecModel.loss``, ``layers.cross_entropy``) against
``jax.value_and_grad`` of the reference's, for every registry
architecture's ``-smoke`` config in fp32.

The same weights (the reference's init, moved through the bridge) and the
same seeded numpy tokens go through both packages.  Init leaves some
gradients at zero or some paths untested, so the fixture draws what would
hide them: RWKV-6's zero ``w_lora_b`` and constant ``w0`` (every channel
one decay, and no gradient into ``w_lora_a``) and the RG-LRU's ``lam``
(a decay below 0.01 a step) get seeded values, as the serve tests do; the
MoE routers are scaled x20 so that routing is far from uniform and the
aux loss moves.

Tolerances: the loss within 1e-5 relative; every gradient leaf within
1e-4 of its leaf's largest magnitude (XLA and PyTorch sum in other
orders; the backward passes of two recurrences and a softmax over 256
words compound them).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch import layers as jL  # noqa: E402
from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch import layers as tL  # noqa: E402
from repro_torch.arch import transformer as tT  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

ARCHS = sorted(jreg.ARCHS)
B, T = 2, 12


def _cfgs(arch):
    name = f"{arch}-smoke"
    return (dataclasses.replace(jreg.get(name), dtype="float32"),
            dataclasses.replace(treg.get(name), dtype="float32"))


def _params(cfg_j, seed=0):
    tree = jax.tree.map(np.array, jbuild(cfg_j).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def visit(t):
        for k, v in t.items():
            if isinstance(v, dict):
                visit(v)
            elif k == "w_lora_b":
                t[k] = rng.normal(0.0, 1.0, v.shape).astype(v.dtype)
            elif k == "w0":
                t[k] = rng.uniform(-6.0, -1.0, v.shape).astype(v.dtype)
            elif k == "lam":
                t[k] = rng.uniform(-9.0, -2.0, v.shape).astype(v.dtype)
            elif k == "router":
                t[k] = (v * 20).astype(v.dtype)

    visit(tree)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, device="cpu")


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)
    labels[0, :3] = -1  # masked positions
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(0, 1, (B, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(0, 1, (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return toks, labels, extra


def _loss_fns(cfg_j, cfg_t, extra):
    jm, tm = jbuild(cfg_j), tbuild(cfg_t)
    if cfg_j.family == "encdec":
        fr = extra["frames"]
        return (lambda p, t, l: jm.loss(p, jnp.asarray(fr), t, l),
                lambda p, t, l: tm.loss(p, torch.from_numpy(fr), t, l))
    if cfg_j.family == "vlm":
        pa = extra["patches"]
        return (lambda p, t, l: jm.loss(p, t, l, patches=jnp.asarray(pa)),
                lambda p, t, l: tm.loss(p, t, l, patches=torch.from_numpy(pa)))
    return jm.loss, tm.loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg_j, cfg_t = _cfgs(arch)
    jp, tp = _params(cfg_j)
    toks, labels, extra = _batch(cfg_j)
    jfn, tfn = _loss_fns(cfg_j, cfg_t, extra)

    jl, jg = jax.jit(jax.value_and_grad(jfn))(jp, jnp.asarray(toks), jnp.asarray(labels))
    tl, tg = value_and_grad(tfn, tp, torch.from_numpy(toks), torch.from_numpy(labels))

    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(zip(sorted(want), (g.numpy() for g in topt.tree_leaves(tg))))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, f"{arch}: {key} has no gradient"
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-4 * max(scale, 1e-30),
                                   err_msg=f"{arch}: {key}")


def test_moe_loss_includes_the_aux_term():
    """granite-moe's loss is the cross entropy plus 0.01 x the summed aux
    loss of its layers, as the reference adds it."""
    cfg_j, cfg_t = _cfgs("granite-moe-1b-a400m")
    _, tp = _params(cfg_j)
    toks, labels, _ = _batch(cfg_j)
    tm = tbuild(cfg_t)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    x, aux = tm._backbone(tp, tL.embed(tp["embed"], tt), None, None, tL.PLAIN)
    ce = tL.cross_entropy(
        tL.unembed(tp["embed"], tL.rmsnorm(tp["final_ln"], x, cfg_t.norm_eps)), tl)
    assert float(aux) > 0
    assert float(tm.loss(tp, tt, tl)) == pytest.approx(float(ce + 0.01 * aux), rel=1e-6)


@pytest.mark.parametrize("all_masked", [False, True])
def test_cross_entropy_matches_reference(all_masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[:, :2] = -1
    if all_masked:
        labels[:] = -1
    want = float(jL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_unrematerialised_gradients(policy):
    """``remat=True`` under either policy recomputes what it did not keep:
    the loss and every gradient equal those without remat, bit for bit on
    the CPU."""
    cfg = dataclasses.replace(treg.get("smollm-360m-smoke"), dtype="float32",
                              remat_policy=policy)
    tm = tbuild(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    toks, labels, _ = _batch(cfg)
    args = (torch.from_numpy(toks), torch.from_numpy(labels))
    l1, g1 = value_and_grad(lambda p, t, l: tm.loss(p, t, l, remat=True), params, *args)
    l0, g0 = value_and_grad(lambda p, t, l: tm.loss(p, t, l, remat=False), params, *args)
    assert torch.equal(l1, l0)
    for a, b in zip(topt.tree_leaves(g1), topt.tree_leaves(g0)):
        assert torch.equal(a, b)
    assert (tT.remat_policy_of(cfg) is None) == (policy == "full")
