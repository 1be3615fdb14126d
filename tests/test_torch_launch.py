"""Port parity: the launch machinery (``repro_torch/launch/specs.py``,
``dryrun.py``) against ``repro/launch``, mirroring ``tests/test_launch.py``:
the live cells, the microbatch bound, the input stand-ins' shapes, the
parameter count of grok-1-314b without an allocation, ``variant_cfg``, the
collective accounting, per-device counting, and one real dry-run cell in a
subprocess (smollm-360m ``decode_32k`` on 16x16, 256 fake ranks)."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from benchmarks.roofline import model_flops  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.launch import dryrun as rdry  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_live_cells_count():
    cells = tspecs.live_cells()
    assert len(cells) == 33
    assert cells == rspecs.live_cells()
    longs = [a for a, s in cells if s == "long_500k"]
    assert sorted(longs) == ["gemma3-12b", "recurrentgemma-2b", "rwkv6-1.6b"]


def test_collective_accounting():
    got = tdry.collective_bytes([("all-reduce", 128 * 256 * 4), ("all-gather", 64 * 512 * 2),
                                 ("collective-permute", 1024), ("all-gather", 10)])
    assert got["all-reduce"] == 2 * 128 * 256 * 4
    assert got["all-gather"] == 64 * 512 * 2 + 10
    assert got["collective-permute"] == 1024
    assert got["total"] == sum(got[c] for c in tdry.COLLECTIVES)
    # the reference's parser on the same collectives
    hlo = """
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256] %x), replica_groups={}
  %ag.1 = bf16[64,512]{1,0} all-gather-start(bf16[64,32] %y)
  %cp = u8[1024]{0} collective-permute(u8[1024] %z)
"""
    want = rdry.collective_bytes(hlo)
    got = tdry.collective_bytes([("all-reduce", 128 * 256 * 4), ("all-gather", 64 * 512 * 2),
                                 ("collective-permute", 1024)])
    assert got == want


@pytest.mark.parametrize("n_dp", [1, 16, 32])
def test_microbatch_choice_matches_reference(n_dp):
    for arch in sorted(ARCHS):
        assert tspecs.choose_microbatches(get(arch), SHAPES["train_4k"], n_dp) == \
            rspecs.choose_microbatches(ARCHS[arch], SHAPES["train_4k"], n_dp)


def test_microbatch_choice_bounds_memory():
    cfg = get("grok-1-314b")
    mb = tspecs.choose_microbatches(cfg, SHAPES["train_4k"], n_dp=32)
    b_local = 256 // 32
    resid = cfg.n_layers * (b_local // mb) * 4096 * cfg.d_model * 2
    assert resid <= 2 * 1024**3 or mb == b_local
    assert tspecs.choose_microbatches(get("smollm-360m"), SHAPES["train_4k"], 32) <= 2


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-medium", "llava-next-34b",
                                  "rwkv6-1.6b", "recurrentgemma-2b", "gemma3-12b"])
def test_input_specs_shapes(arch):
    for shape in SHAPES:
        want = rspecs.input_specs(arch, shape, n_dp=32)
        got = tspecs.input_specs(arch, shape, n_dp=32)
        for key in ("batch", "caches"):
            if key in want:
                w = {"/".join(str(getattr(q, "key", q)) for q in p): (tuple(x.shape), str(x.dtype))
                     for p, x in jax.tree_util.tree_flatten_with_path(want[key])[0]}
                g = {}
                tdry.map_with_path(lambda p, x: g.__setitem__(
                    "/".join(p), (tuple(x.shape), str(x.dtype).removeprefix("torch."))), got[key])
                assert g == w, (arch, shape, key)
        assert all(t.device.type == "meta" for t in tree_leaves(got["batch"]))
        assert got.get("microbatches") == want.get("microbatches")
    sp = tspecs.input_specs(arch, "train_4k", n_dp=32)
    tok = sp["batch"]["tokens"]
    assert tok.shape[0] * tok.shape[1] == 256 and tok.shape[2] == 4096
    assert tspecs.input_specs(arch, "decode_32k", n_dp=32)["batch"]["tokens"].shape == (128, 1)


def test_variant_cfg_scales_layers():
    cfg = get("granite-8b")
    assert tdry.variant_cfg(cfg, 2, tdry.scan_unit(cfg)).n_layers == 2
    w = get("whisper-medium")
    v = tdry.variant_cfg(w, 1, tdry.scan_unit(w))
    assert v.n_layers == 1 and v.encoder_layers == 1
    h = get("recurrentgemma-2b")
    u = h.rnn_per_attention + 1
    assert tdry.variant_cfg(h, 2, u).n_layers == 2 * u
    for arch in sorted(ARCHS):
        assert tdry.scan_unit(get(arch)) == rdry.scan_unit(ARCHS[arch])
        assert tdry.cached_scan_unit(get(arch)) == rdry.cached_scan_unit(ARCHS[arch])


def test_params_shapes_no_allocation():
    shapes = tspecs.params_shapes(get("grok-1-314b"))
    leaves = tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(math.prod(t.shape) for t in leaves) > 250e9  # ~314B without allocating
    opt = tspecs.opt_shapes(shapes)
    assert all(t.device.type == "meta" for t in tree_leaves(opt))


def test_local_cost_counts_one_device_share(tmp_path):
    """A (64, 128) @ (128, 256) product on a 2x2 fake mesh, rows over data
    and columns over model: each device multiplies a quarter, and the
    row-sharded operand's gather over model is counted."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    tdry.open_fake_world(4)
    try:
        mesh = torch.distributed.device_mesh.init_device_mesh(
            "cpu", (2, 2), mesh_dim_names=("data", "model"))
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        with fm:
            a = distribute_tensor(torch.empty(64, 128), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            b = distribute_tensor(torch.empty(128, 256), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
        cost = tdry.LocalCost(fm)
        with cost:
            out = a @ b
        assert out.placements == (Shard(0), Shard(1))
        assert cost.flops == 2 * 64 * 128 * 256 / 4
        assert cost.collectives == []
        with cost:
            out.redistribute(mesh, [Shard(0), Replicate()])
        assert cost.collectives == [("all-gather", 32 * 256 * 4)]
    finally:
        dist.destroy_process_group()


def test_dryrun_single_cell_subprocess(tmp_path):
    """A real dry-run cell end to end: 256 fake ranks in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "smollm-360m", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.load(open(tmp_path / "smollm-360m__decode_32k__16x16.json"))
    for key in ("arch", "shape", "mesh", "n_devices", "kind", "compile_s", "memory",
                "cost_per_device", "collective_bytes_per_device", "scan_units",
                "microbatches"):
        assert key in rec
    assert (rec["mesh"], rec["n_devices"], rec["kind"], rec["scan_units"]) == \
        ("16x16", 256, "decode", 32)
    assert rec["cost_per_device"]["flops"] > 0
    assert 0 < rec["memory"]["peak_estimate_bytes"] < hw.HBM_BYTES
    # per device: 256 devices do at least the analytic useful work, and at
    # most twice it (a count at the DTensor level would give 256 times it)
    useful = model_flops("smollm-360m", "decode_32k")
    assert 0.95 * useful <= rec["cost_per_device"]["flops"] * 256 <= 2.0 * useful
    assert rec["collective_bytes_per_device"]["total"] > 0
