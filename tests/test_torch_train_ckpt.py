"""Port parity: training checkpoints (``repro_torch.ckpt.checkpoint``)
against the reference's ``repro.ckpt.checkpoint``.

A checkpoint written by either package restores in the other bit for bit,
bf16 leaves included (stored as uint16 bits, the dtype in the manifest),
with the same npz keys (``/``-joined paths in JAX's sorted-key order) and
the same manifest.  The asynchronous saver publishes by rename, keeps the
newest ``keep`` steps and never lists a half-written directory.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.train import optim as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt import checkpoint as tck  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402


def _state(arch="smollm-360m-smoke", seed=0):
    """A (jax, torch) pair of {"params", "opt"} trees with equal bits: the
    reference's bf16 init and an optimizer state with seeded moments."""
    params = jax.tree.map(np.array, jbuild(jreg.get(arch)).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    noise = lambda a: rng.normal(0, 1, a.shape).astype(np.float32)  # noqa: E731
    opt = {"m": jax.tree.map(noise, params), "v": jax.tree.map(noise, params),
           "step": np.asarray(7, np.int32)}
    tree = {"params": params, "opt": opt}
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, device="cpu")


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _equal_trees(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tck._paths(ttree)
    assert ["/".join(str(k.key) for k in p) for p, _ in jl] == [k for k, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert str(np.asarray(a).dtype) == tck.dtype_name(b.dtype)
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "recurrentgemma-2b-smoke"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    jtree, ttree = _state(arch)
    jck.save(str(tmp_path), 3, jtree, extra={"next_step": 3})
    like = topt.tree_map(torch.zeros_like, ttree)
    got, extra = tck.restore(str(tmp_path), like)
    assert extra == {"next_step": 3}
    _equal_trees(jtree, got)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _state()
    tck.save(str(tmp_path), 5, ttree, extra={"next_step": 5})
    like = jax.tree.map(jnp.zeros_like, jtree)
    got, extra = jck.restore(str(tmp_path), like)
    assert extra == {"next_step": 5}
    _equal_trees(got, ttree)


def test_manifests_and_keys_equal(tmp_path):
    jtree, ttree = _state()
    jck.save(str(tmp_path / "j"), 1, jtree)
    tck.save(str(tmp_path / "t"), 1, ttree)

    def read(d):
        path = os.path.join(d, "step_00000001")
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            return m, {k: (z[k].dtype, z[k].shape) for k in z.files}

    assert read(str(tmp_path / "t")) == read(str(tmp_path / "j"))


def test_async_checkpointer_keeps_the_newest_and_snapshots_at_call(tmp_path):
    d = str(tmp_path)
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "h": torch.ones(4, dtype=torch.bfloat16)}
    saver = tck.AsyncCheckpointer(d, keep=2)
    for step in (1, 2, 3):
        saver.save_async(step, t, extra={"next_step": step})
        t["w"].add_(1)  # training goes on at once; the snapshot was taken
    saver.wait()
    assert tck.list_steps(d) == [2, 3] and tck.latest_step(d) == 3
    got, extra = tck.restore(d, t)
    assert extra == {"next_step": 3}
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32).reshape(2, 3) + 2)
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], t["h"])
    got1, _ = tck.restore(d, t, step=2)
    assert torch.equal(got1["w"], got["w"] - 1)
    os.makedirs(os.path.join(d, "step_00000009.tmp0"))  # a save cut short
    assert tck.latest_step(d) == 3
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), t)
