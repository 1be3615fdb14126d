"""Port parity: the parallel layer (``repro_torch/parallel``) and the mesh
pricing (``core/mapper.py``) against the reference's.

* ``ShardingPlan`` gives the reference's spec, entry for entry, for every
  leaf of every registry architecture's parameters (``fsdp`` true and
  false), decode caches and batches, on stand-in meshes of 1x1, 16x16 and
  2x16x16 (the reference's own test passes such a ``FakeMesh``).
* The activation policy's spec equals the one the reference's ``shard``
  hands ``with_sharding_constraint`` (captured by patching it).
* int8 compression: ``quantize_roundtrip`` and ``error_feedback_update``
  bitwise; ``compressed_psum`` on a one-rank gloo group bitwise the
  reference's on its one-device mesh.
* ``mesh_dataflow_cost`` on the TPU description bitwise the reference's.

Inputs are drawn from numpy seeds and handed to both packages.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.core import mapper as rmap  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.parallel import collectives as RC  # noqa: E402
from repro.parallel import policy as rpolicy  # noqa: E402
from repro.parallel.sharding import ShardingPlan as RPlan  # noqa: E402
from repro_torch.configs.registry import get as tget  # noqa: E402
from repro_torch.core import mapper as tmap  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.parallel import collectives as TC  # noqa: E402
from repro_torch.parallel import policy as tpolicy  # noqa: E402
from repro_torch.parallel.sharding import P, ShardingPlan, map_with_path, placements  # noqa: E402


def fake_mesh(shape: dict):
    return type("FakeMesh", (), {"axis_names": tuple(shape), "shape": dict(shape)})()


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def jax_specs(tree) -> dict:
    """{path: spec entries} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in p): tuple(s)
            for p, s in flat}


def port_specs(tree) -> dict:
    out = {}
    map_with_path(lambda p, s: out.__setitem__("/".join(p), tuple(s)), tree)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return rspecs.params_shapes(ARCHS[arch])


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return tspecs.params_shapes(tget(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_matches_reference(arch, mesh):
    m = fake_mesh(MESHES[mesh])
    rplan, tplan = RPlan(m), ShardingPlan(m)
    for fsdp in (True, False):
        want = jax_specs(rplan.param_spec(ref_params(arch), fsdp=fsdp))
        got = port_specs(tplan.param_spec(port_params(arch), fsdp=fsdp))
        assert got == want, (arch, mesh, fsdp)
    # the optimizer state mirrors the parameters, beside a replicated step
    ospec = tplan.opt_state_spec(tplan.param_spec(port_params(arch)))
    assert ospec["step"] == P() and port_specs(ospec["m"]) == port_specs(ospec["v"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_batch_specs_match_reference(arch, mesh):
    m = fake_mesh(MESHES[mesh])
    rplan, tplan = RPlan(m), ShardingPlan(m)
    for shape in ("decode_32k", "long_500k"):
        sh = SHAPES[shape]
        rc = rspecs.cache_shapes(ARCHS[arch], sh.global_batch, sh.seq_len)
        tc = tspecs.cache_shapes(tget(arch), sh.global_batch, sh.seq_len)
        assert port_specs(tplan.cache_spec(tc)) == jax_specs(rplan.cache_spec(rc))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rb = rspecs.input_specs(arch, shape, n_dp=16)["batch"]
        tb = tspecs.input_specs(arch, shape, n_dp=16)["batch"]
        assert port_specs(tplan.batch_spec(tb)) == jax_specs(rplan.batch_spec(rb))


def test_uneven_dims_fall_back_to_replication():
    plan = ShardingPlan(fake_mesh({"model": 16}))
    assert plan._fit((49155, 64), ("model", None)) == P(None, None)
    assert plan._fit((49152, 64), ("model", None)) == P("model", None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = fake_mesh(MESHES["2x16x16"])
    m.mesh_dim_names = ("pod", "data", "model")
    # a dimension over ("pod", "data") is sharded on both mesh dimensions
    assert placements(m, P(("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert placements(m, P(None, "data")) == [Replicate(), Shard(1), Replicate()]
    assert placements(m, P()) == [Replicate()] * 3


POLICY_CASES = [
    ((8, 16, 960), ("batch", "seq", "heads")),
    ((8, 16, 320), ("batch", "seq", "kv_heads")),
    ((8, 16, 2560), ("batch", "seq", "ff")),
    ((8, 16, 960), ("batch", "seq", "embed")),
    ((8, 16, 49152), ("batch", "seq", "vocab")),
    ((8, 16, 49155), ("batch", "seq", "vocab")),
    ((128, 49152), ("seq", "vocab")),
    ((256, 8, 40, 1024), ("batch", "expert", None, "embed")),
    ((1, 8, 40, 4096), ("batch", "expert", None, "ff")),
    ((32, 4096), ("batch", "kv_seq")),
]


@pytest.mark.parametrize("rules", [None, {"seq": "model"}, {"batch": None, "embed": "data"}])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_policy_spec_matches_reference(monkeypatch, mesh, rules):
    m = fake_mesh(MESHES[mesh])
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    with rpolicy.activate(m, rules):
        for shape, names in POLICY_CASES:
            rpolicy.shard(jnp.zeros(shape, jnp.int8), *names)
    with tpolicy.activate(m, rules):
        got = [tpolicy.spec_of(shape, *names) for shape, names in POLICY_CASES]
        assert tpolicy.active()
    assert not tpolicy.active()
    assert [tuple(s) for s in got] == [tuple(s) for s in seen]
    assert tpolicy.default_rules(m) == rpolicy.default_rules(m)


def test_shard_is_identity_without_a_policy_or_on_plain_tensors():
    x = torch.randn(4, 8, 960)
    assert tpolicy.shard(x, "batch", "seq", "heads") is x
    with tpolicy.activate(fake_mesh(MESHES["16x16"])):
        assert tpolicy.shard(x, "batch", "seq", "heads") is x
        with pytest.raises(ValueError):
            tpolicy.shard(x, "batch", "seq")


# ------------------------------------------------------------ compression --


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_roundtrip_bitwise(n, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * 10).astype(np.float32)
    x[: n // 7] = 0.0  # all-zero blocks take the 1e-12 scale floor
    want = np.asarray(RC.quantize_roundtrip(jnp.asarray(x)))
    got = TC.quantize_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # per-block scale = max/127: error <= scale/2 <= max|x|/254
    assert np.abs(got - x).max() <= np.abs(x).max() / 254 * 1.01 + 1e-6


def test_error_feedback_update_bitwise():
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((64, 96)).astype(np.float32),
         "b": {"c": rng.standard_normal(300).astype(np.float32)}}
    rres, tres = RC.init_residual(jax.tree.map(jnp.asarray, g)), TC.init_residual(
        {"w": torch.from_numpy(g["w"]), "b": {"c": torch.from_numpy(g["b"]["c"])}})
    rg = jax.tree.map(jnp.asarray, g)
    tg = {"w": torch.from_numpy(g["w"]), "b": {"c": torch.from_numpy(g["b"]["c"])}}
    for _ in range(4):
        rq, rres = RC.error_feedback_update(rg, rres)
        tq, tres = TC.error_feedback_update(tg, tres)
        for key in ("w",):
            np.testing.assert_array_equal(tq[key].numpy(), np.asarray(rq[key]))
            np.testing.assert_array_equal(tres[key].numpy(), np.asarray(rres[key]))
        np.testing.assert_array_equal(tq["b"]["c"].numpy(), np.asarray(rq["b"]["c"]))
        np.testing.assert_array_equal(tres["b"]["c"].numpy(), np.asarray(rres["b"]["c"]))


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_one_rank_matches_reference(one_rank_mesh, monkeypatch):
    # this JAX's experimental shard_map predates the reference's check_vma
    # keyword (the older name is check_rep)
    orig = RC.shard_map

    def shard_map(f, *, check_vma=True, **kw):
        try:
            return orig(f, check_vma=check_vma, **kw)
        except TypeError:
            return orig(f, check_rep=check_vma, **kw)

    monkeypatch.setattr(RC, "shard_map", shard_map)
    x = (np.random.default_rng(5).standard_normal((37, 50)) * 3).astype(np.float32)
    rmesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(RC.compressed_psum(jnp.asarray(x), rmesh))
    got = TC.compressed_psum(torch.from_numpy(x), one_rank_mesh)
    np.testing.assert_array_equal(got.numpy(), want)
    # one rank: the round trip itself
    np.testing.assert_array_equal(got.numpy(), TC.quantize_roundtrip(torch.from_numpy(x)).numpy())


# ------------------------------------------------------------ mesh pricing --


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_mesh_dataflow_cost_tpu_bitwise(n_chips):
    rng = np.random.default_rng(n_chips)
    for _ in range(8):
        flops, hbm, coll = (float(v) for v in rng.uniform(1e9, 1e16, 3))
        for links in (None, 1, 4):
            kw = {} if links is None else {"ici_links": links}
            want = rmap.mesh_dataflow_cost(flops=flops, hbm_bytes=hbm, collective_bytes=coll,
                                           n_chips=n_chips, **kw)
            got = tmap.mesh_dataflow_cost(flops=flops, hbm_bytes=hbm, collective_bytes=coll,
                                          n_chips=n_chips, hardware=tmap.MeshHardware.tpu_v5e(),
                                          **kw)
            assert got == want
            assert tmap.dominant_term(got) == rmap.dominant_term(want)


def test_mesh_dataflow_cost_prices_the_h100_by_default():
    from repro_torch import hw

    got = tmap.mesh_dataflow_cost(flops=989e12, hbm_bytes=3.35e12, collective_bytes=450e9,
                                  n_chips=1)
    assert got == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert hw.NVLINK_LINKS * hw.NVLINK_BYTES_PER_S_PER_LINK * 2 == 900e9
    assert tmap.dominant_term({"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5}) == "memory_s"


def test_mesh_dataflow_label_matches_reference():
    axes = (("data", (("batch", 8), ("seq", 2))), ("model", ()))
    assert tmap.MeshDataflow(axes).label() == rmap.MeshDataflow(axes).label()
    assert dataclasses.asdict(tmap.MeshDataflow(axes)) == dataclasses.asdict(
        rmap.MeshDataflow(axes))
