"""Port parity: configs, the parameter bridge and ``Model.init``.

The port keeps its own copy of every config module; each must equal the
reference's field for field.  The bridge must round-trip every dense smoke
config's reference ``Model.init`` bit-exactly (bf16 as uint16 bits), and
the port's own ``Model.init`` must produce the reference's tree: same
paths, shapes and dtypes, and the same distributions.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.arch.model_zoo import build as jbuild  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.arch.model_zoo import build as tbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402

DENSE_SMOKE = [n + "-smoke" for n, c in jreg.ARCHS.items() if c.family == "dense"]


@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
def test_config_copies_match_reference(name):
    for n in (name, name + "-smoke"):
        assert dataclasses.asdict(treg.get(n)) == dataclasses.asdict(jreg.get(n))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", DENSE_SMOKE)
def test_bridge_round_trip_exact(name):
    params = jbuild(jreg.get(name)).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    port = bridge.params_from_jax(tree)
    back = bridge.params_to_jax(port, bf16_dtype=jnp.bfloat16)
    want, got = _flat(tree), _flat(back)
    assert want.keys() == got.keys()
    for path, a in want.items():
        b = got[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        # compare raw bits: exact, NaN-safe
        assert a.tobytes() == b.tobytes(), path
    for path, t in _flat(port).items():
        assert tuple(t.shape) == want[path].shape, path


def test_bridge_bf16_as_uint16_bits():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = bridge.params_from_jax({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    bits = bridge.params_to_jax({"w": t})["w"]
    assert bits.dtype == np.uint16 and np.array_equal(bits, a.view(np.uint16))


def test_port_init_matches_reference_tree():
    cfg_j, cfg_t = jreg.get("smollm-360m-smoke"), treg.get("smollm-360m-smoke")
    want = _flat(jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0))))
    got = _flat(tbuild(cfg_t).init(torch.Generator().manual_seed(0)))
    assert want.keys() == got.keys()
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, path
    # same distributions: unit norm scales, normal(0.02) embeddings,
    # normal(0.02 / sqrt(d)) projections
    d = cfg_t.d_model
    assert torch.equal(got["/final_ln/scale"], torch.ones(d))
    tok = got["/embed/tok"].float()
    assert abs(tok.std().item() - 0.02) < 0.002 and abs(tok.mean().item()) < 0.002
    wq = got["/layers/attn/wq"].float()
    assert abs(wq.std().item() - 0.02 / d**0.5) < 0.0003


def test_unported_families_name_their_roadmap_item():
    for name in ("recurrentgemma-2b-smoke", "granite-moe-1b-a400m-smoke",
                 "gemma3-12b-smoke", "whisper-medium-smoke"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbuild(treg.get(name))
