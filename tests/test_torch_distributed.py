"""The parallel layer across real ranks: gloo process groups of 2 and 4
ranks on the CPU, spawned through ``file://`` stores (no port, no
network), each rank one process.

* ``compressed_psum`` at 2 and 4 ranks against the reference's formula
  (``repro/parallel/collectives.py:58-72``) evaluated in numpy on the
  per-rank inputs;
* one fp32 train step of smollm-360m-smoke on a 2x2 mesh, with and without
  ``accum_spec``, against the same step in one process: the loss, the
  gradients' global norm, every element of the first moment (0.1 x the
  gradient) and every parameter within 1e-5 of its leaf's scale.  The
  step's AdamW takes eps 1e-3: the first step moves a parameter by lr * g /
  (|g| + eps), so with the default 1e-8 a gradient element near 1e-8 turns
  the rounding of sums taken in another order (about 4e-7 of the leaf's
  scale, the moments show) into a 1e-3 share of lr; with 1e-3 the update is
  linear in g and the parameters show the mesh's arithmetic;
* ``ckpt.restore(shardings=)``: a checkpoint written with no mesh restores
  onto the 2x2 mesh bit for bit, each rank's local shard its slice, and a
  checkpoint of DTensors (rank 0 writes) restores with no mesh bit for bit;
* the launcher's ``main`` at 2 ranks against its one-rank run: every loss
  within 1e-5 of scale;
* one fp32 train step each of rwkv6, recurrentgemma and granite-moe
  (smoke widths) on the 2x2 mesh, with the default rules (rows over
  'data', heads over 'model'), with the heads whole (rows only) and with
  the rows whole (heads only), against the same step in one process, as
  smollm's above: the scan and WKV-6 split by rows, channels and heads,
  WKV-6's ``u`` gradient a partial sum over rows, the experts' partial
  outputs and gradients, and attention on each rank's rows and heads;
* ``policy.write_slots`` into a cache split by rows over 'data' and by
  slots over 'model', against plain indexing of the whole cache, bitwise.

Each world runs once (a module fixture) and writes its readings to a file;
the tests read them.  Inputs come from numpy seeds.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LAUNCH = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
          "--microbatches", "2"]


def psum_input(rank: int) -> np.ndarray:
    return (np.random.default_rng(100 + rank).standard_normal((7, 90)) * (rank + 1)).astype(
        np.float32)


def psum_formula(n: int) -> np.ndarray:
    """The reference's compressed mean in numpy: each rank's int8 blocks
    and scales summed, then qsum * (ssum / n) / n."""
    qs, ss = [], []
    for r in range(n):
        flat = psum_input(r).reshape(-1)
        flat = np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
        scale = np.maximum(np.abs(flat).max(axis=1, keepdims=True) / np.float32(127.0),
                           np.float32(1e-12))
        qs.append(np.clip(np.round(flat / scale), -127, 127).astype(np.int32))
        ss.append(scale)
    qsum, ssum = sum(qs), sum(ss[1:], ss[0].copy())
    deq = qsum.astype(np.float32) * (ssum / np.float32(n)) / np.float32(n)
    return deq.reshape(-1)[: 7 * 90].reshape(7, 90)


ZOO = ["rwkv6-1.6b", "recurrentgemma-2b", "granite-moe-1b-a400m"]
# the policy's rules beside the default: heads (and the other 'model'
# dimensions) whole, and rows whole
RULES = {"rows_heads": {},
         "rows": {"heads": None, "kv_heads": None, "ff": None, "vocab": None},
         "heads": {"batch": None}}
OCFG = dict(lr=3e-3, warmup_steps=1, eps=1e-3)


def _smoke_cfg(arch: str = "smollm-360m"):
    from repro_torch.configs.registry import get

    return dataclasses.replace(get(f"{arch}-smoke"), dtype="float32")


def _init(cfg):
    from repro_torch.arch.model_zoo import build
    from repro_torch.train import optim

    params = build(cfg).init(torch.Generator().manual_seed(0))
    return params, optim.init_state(params)


def _batch(cfg):
    from repro_torch.data.pipeline import DataConfig, batch_at

    b = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8), 0)
    return {k: torch.from_numpy(v).reshape(2, 4, 16) for k, v in b.items()}


def _worker(rank: int, world: int, init: str, out_dir: str) -> None:
    sys.path.insert(0, os.path.join(REPO, "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        _job(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


def _job(rank: int, world: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train as launcher
    from repro_torch.launch.steps import make_train_step
    from repro_torch.parallel import policy
    from repro_torch.parallel.collectives import compressed_psum
    from repro_torch.parallel.sharding import P, ShardingPlan
    from repro_torch.train import optim

    res = {}
    shape = (world // 2, 2) if world == 4 else (world, 1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    # compressed_psum over every rank: a (world, 1) mesh's data axis
    flat = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    got = compressed_psum(torch.from_numpy(psum_input(rank)), flat)
    res["psum"] = got.numpy().tolist()

    if world == 4:
        cfg = _smoke_cfg()
        plan = ShardingPlan(mesh)
        ocfg = optim.AdamWConfig(**OCFG)
        for tag, accum in (("step", False), ("step_accum", True)):
            params, opt = _init(cfg)
            pspec = plan.param_spec(params)
            params = plan.place(params, pspec)
            opt = plan.place(opt, plan.opt_state_spec(pspec))
            batch = plan.place(_batch(cfg), {k: P(None, "data", None) for k in ("tokens", "labels")})
            step = make_train_step(cfg, ocfg, accum_spec=pspec if accum else None)
            with policy.activate(mesh):
                params, opt, metrics = step(params, opt, batch)
            res[tag] = {"loss": float(metrics["loss"].full_tensor()),
                        "grad_norm": float(metrics["grad_norm"].full_tensor()),
                        "params": [p.full_tensor().tolist() for p in optim.tree_leaves(params)],
                        "m": [p.full_tensor().tolist() for p in optim.tree_leaves(opt["m"])]}

        # elastic restore: a checkpoint with no mesh onto the mesh ...
        d = os.path.join(out_dir, "ckpt")
        params, _ = _init(cfg)
        if rank == 0:
            ckpt.save(d, 1, {"params": params})
        dist.barrier()
        pspec = plan.param_spec(params)
        placed, _ = ckpt.restore(d, {"params": params}, step=1,
                                 shardings={"params": plan.shardings(pspec)})
        want = plan.place(params, pspec)
        leaves = list(zip(optim.tree_leaves(placed["params"]), optim.tree_leaves(want),
                          optim.tree_leaves(params)))
        res["restore_local"] = all(torch.equal(a.to_local(), b.to_local()) for a, b, _ in leaves)
        res["restore_full"] = all(torch.equal(a.full_tensor(), c) for a, _, c in leaves)
        res["restore_sharded"] = sum(a.to_local().numel() < c.numel() for a, _, c in leaves)
        # ... and a checkpoint of DTensors (rank 0 writes) with no mesh
        ckpt.save(d, 2, {"params": placed["params"]})
        dist.barrier()
        back, _ = ckpt.restore(d, {"params": params}, step=2)
        res["restore_back"] = all(torch.equal(a, b) for a, b in zip(
            optim.tree_leaves(back["params"]), optim.tree_leaves(params)))
        zoo = _zoo_steps(mesh, plan, res)
        if rank == 0:
            torch.save(zoo, os.path.join(out_dir, "zoo.pt"))
        res["slots"] = _slot_writes(mesh)
    else:
        res["launch"] = launcher.main(LAUNCH)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _one_step(cfg, params, opt, batch, accum_spec=None):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optim

    step = make_train_step(cfg, optim.AdamWConfig(**OCFG), accum_spec=accum_spec)
    return step(params, opt, batch)


def _readings(params, opt, metrics) -> dict:
    """A step's loss, gradient norm, parameters and first moment, whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train import optim

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    return {"loss": float(full(metrics["loss"])), "grad_norm": float(full(metrics["grad_norm"])),
            "params": [full(p) for p in optim.tree_leaves(params)],
            "m": [full(m) for m in optim.tree_leaves(opt["m"])]}


def _zoo_steps(mesh, plan, res: dict) -> dict:
    """One step of each ZOO arch on the mesh under each of RULES; the
    losses into ``res`` (every rank), the whole readings returned."""
    from repro_torch.parallel import policy
    from repro_torch.parallel.sharding import P

    zoo = {}
    for arch in ZOO:
        cfg = _smoke_cfg(arch)
        for tag, rules in RULES.items():
            params, opt = _init(cfg)
            pspec = plan.param_spec(params)
            params = plan.place(params, pspec)
            opt = plan.place(opt, plan.opt_state_spec(pspec))
            batch = plan.place(_batch(cfg), {k: P(None, "data", None) for k in ("tokens", "labels")})
            with policy.activate(mesh, rules):
                got = _readings(*_one_step(cfg, params, opt, batch, accum_spec=pspec))
            zoo[f"{arch}/{tag}"] = got
            res[f"zoo_loss/{arch}/{tag}"] = got["loss"]
    return zoo


def slot_case(case: int):
    """(cache (B, S, 2, 3) fp32, pos (B, S) int32, slots (B, T), vals
    (B, T, 2, 3), pos values (B, T)) from a numpy seed: a row's T slots are
    distinct and run on from a random start around the ring of S = 8, so
    they cross the slot shards' boundary; T = 1 is decode."""
    rng = np.random.default_rng(200 + case)
    B, S, T = 4, 8, (1, 3, 5, 8)[case]
    start = rng.integers(0, S, size=(B, 1))
    slots = (start + np.arange(T)) % S
    cache = rng.standard_normal((B, S, 2, 3)).astype(np.float32)
    pos = rng.integers(0, 100, size=(B, S)).astype(np.int32)
    vals = rng.standard_normal((B, T, 2, 3)).astype(np.float32)
    pvals = rng.integers(100, 200, size=(B, T)).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (cache, pos, slots, vals, pvals))


def _slot_writes(mesh) -> list[bool]:
    """write_slots into caches split by rows over 'data' and slots over
    'model', the values plain (whole) and as DTensors split by rows, against
    plain indexing: bitwise, one flag a case."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel.policy import write_slots

    ok = []
    split = [Shard(0), Shard(1)]
    for case in range(4):
        for dvals in (False, True):
            cache, pos, slots, vals, pvals = slot_case(case)
            want_c, want_p = cache.clone(), pos.clone()
            rows = torch.arange(4)[:, None]
            want_c[rows, slots], want_p[rows, slots] = vals, pvals
            dc = distribute_tensor(cache, mesh, split)
            dp = distribute_tensor(pos, mesh, split)
            if dvals:
                vals, pvals = (distribute_tensor(x, mesh, [Shard(0), Replicate()])
                               for x in (vals, pvals))
            write_slots(slots, ((dc, vals), (dp, pvals)))
            ok.append(torch.equal(dc.full_tensor(), want_c)
                      and torch.equal(dp.full_tensor(), want_p))
    return ok


def _spawn(world: int, tmp: str) -> list[dict]:
    store = os.path.join(tmp, "store")
    mp.start_processes(_worker, args=(world, f"file://{store}", tmp), nprocs=world,
                       join=True, start_method="spawn")
    res = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(world)]
    zoo = os.path.join(tmp, "zoo.pt")
    if os.path.exists(zoo):
        res[0]["zoo"] = torch.load(zoo)
    return res


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, str(tmp_path_factory.mktemp("world4")))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def one_process_step():
    """The step of the world-4 job in this process, no mesh."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optim

    cfg = _smoke_cfg()
    params, opt = _init(cfg)
    step = make_train_step(cfg, optim.AdamWConfig(**OCFG))
    params, opt, metrics = step(params, opt, _batch(cfg))
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            [p.numpy() for p in optim.tree_leaves(params)],
            [m.numpy() for m in optim.tree_leaves(opt["m"])])


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_formula(world, request):
    res = request.getfixturevalue(f"world{world}")
    want = psum_formula(world)
    scale = np.abs(want).max()
    for r in res:
        got = np.asarray(r["psum"], dtype=np.float32)
        # the int8 sums are exact; the fp32 scale sum may add in another order
        assert np.abs(got - want).max() <= TOL * scale
    assert all(r["psum"] == res[0]["psum"] for r in res)


@pytest.mark.parametrize("tag", ["step", "step_accum"])
def test_train_step_on_2x2_mesh_matches_one_process(world4, one_process_step, tag):
    loss, gnorm, params, moments = one_process_step
    got = world4[0][tag]
    assert abs(got["loss"] - loss) <= TOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= TOL * gnorm
    assert len(got["params"]) == len(params) == len(got["m"]) == len(moments)
    for g, w in zip(got["params"] + got["m"], params + moments):
        g = np.asarray(g, dtype=np.float32)
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30)
    # every rank holds the same whole result
    assert all(r[tag]["loss"] == got["loss"] for r in world4)


def test_restore_with_shardings(world4):
    for r in world4:
        assert r["restore_local"] and r["restore_full"] and r["restore_back"]
        assert r["restore_sharded"] > 0  # some leaves really are split


def test_launcher_at_two_ranks_matches_one_rank(world2, tmp_path):
    from repro_torch.launch import train as launcher

    try:
        want = launcher.main(LAUNCH)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for r in world2:
        got = r["launch"]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert abs(g - w) <= TOL * abs(w)


def _close(got, want, what: str) -> None:
    """Every element within TOL of the leaf's scale."""
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= TOL * scale, what


@pytest.mark.parametrize("tag", list(RULES))
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_step_on_2x2_mesh_matches_one_process(world4, arch, tag):
    sys.path.insert(0, os.path.join(REPO, "src"))
    cfg = _smoke_cfg(arch)
    want = _readings(*_one_step(cfg, *_init(cfg), _batch(cfg)))
    got = world4[0]["zoo"][f"{arch}/{tag}"]
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= TOL * want["grad_norm"]
    assert len(got["params"]) == len(want["params"]) == len(got["m"]) == len(want["m"])
    for i, (g, w) in enumerate(zip(got["params"] + got["m"], want["params"] + want["m"])):
        _close(g, w, f"{arch}/{tag} leaf {i}")
    assert all(r[f"zoo_loss/{arch}/{tag}"] == got["loss"] for r in world4)


@pytest.mark.parametrize("case", range(4))
def test_write_slots_on_sharded_cache_matches_indexing(world4, case):
    for r in world4:
        assert r["slots"][2 * case: 2 * case + 2] == [True, True]
