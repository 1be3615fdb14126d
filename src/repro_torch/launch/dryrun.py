"""Multi-pod dry-run; port of ``repro/launch/dryrun.py``.

For every live (architecture x input shape) cell and both production meshes
(16x16 single pod, 2x16x16 multi-pod), this program:

  1. opens a fake process group of 256 or 512 ranks in this one process
     (``torch.testing``'s ``FakeStore``: collectives return at once) and
     the production ``DeviceMesh`` over it,
  2. builds the step function (train_step or serve_step per the shape kind)
     and traces it under ``FakeTensorMode`` on DTensor parameters, optimizer
     state, batch and caches placed by ``parallel/sharding.py`` - a sharding
     that cannot propagate fails here, which is the point (where the
     reference lowers and compiles, the port runs the step's Python on
     tensors that have shapes and no data),
  3. records memory per device: the arguments' bytes at full depth, exactly,
     from each leaf's local shard; the step's temporary peak, the most
     bytes of this device's new storages alive at once, on the traced units,
  4. reconstructs whole-program cost with the reference's A/B trick: trace
     the model at 1 and 2 scan units -> body = c2 - c1, then total = c1 +
     (units - 1) * body.  The reference needs it because XLA counts a loop
     body once; the port because an eager trace runs every Python
     iteration (and so it also bounds the trace's time),
  5. counts per device: flops and bytes on the LOCAL tensors of every
     operation (a DTensor-level count would give the whole product, not one
     device's share), and collective bytes from the results of the
     functional collectives DTensor issues, under the reference's rule
     (all-reduce twice its result bytes),
  6. writes experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

Flops count the products (``torch.utils.flop_counter``'s formulas) and the
two recurrences (2 operations a scan element, 7 a WKV-6 state element and
step); bytes count each non-view operation's inputs and outputs.  The fake
CPU mesh moves a tensor from one sharded dimension to another as an
all-gather and a chunk where a CUDA mesh issues an all-to-all: such moves
are counted as the all-gathers they are here (``collective_note``).

Memory: ``peak_estimate_bytes`` = ``argument_bytes`` + ``temp_bytes``, where
``temp_bytes`` is the peak of what the step allocates (its new outputs,
``output_bytes``, included) and ``alias_bytes`` the arguments it updates in
place (parameters and optimizer state, or caches).  The fit is judged
against one H100's 80 GB (``hw.HBM_BYTES``).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --multi-pod
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
import weakref
from typing import Iterable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import hw
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, live_cells
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.parallel import policy
from repro_torch.parallel.sharding import P, ShardingPlan, map_with_path, placements
from repro_torch.train import optim

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# the functional collectives DTensor issues, by the reference's names
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

COLLECTIVE_NOTE = ("fake CPU mesh: a shard-to-shard move is an all-gather and a chunk, "
                   "counted as all-gather, where a CUDA mesh issues an all-to-all")


def collective_bytes(results: Iterable[tuple[str, float]]) -> dict[str, float]:
    """Sum result bytes of collectives, given as (reference name, result
    bytes) pairs.

    Accounting: all-reduce counted 2x result bytes (ring reduce+broadcast);
    others 1x result bytes."""
    out = {c: 0.0 for c in COLLECTIVES}
    for op, nbytes in results:
        mult = 2.0 if op == "all-reduce" else 1.0
        out[op] += mult * nbytes
    out["total"] = sum(out[c] for c in COLLECTIVES)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


class LocalCost(TorchDispatchMode):
    """Flops, bytes, collectives and the peak of live storages of the
    operations on the trace's local tensors: DTensor operations are left to
    DTensor, whose local operations then come back through this mode.  Only
    operations on a fake tensor of ``fake_mode`` count: DTensor's sharding
    propagation runs operations of its own, on global-shaped tensors of
    another fake mode and on small real index tensors, which are no
    device's memory."""

    def __init__(self, fake_mode: FakeTensorMode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, float]] = []
        self.live: dict[int, int] = {}   # id(storage) -> bytes, while it lives
        self.live_bytes = 0
        self.peak_bytes = 0

    def _allocated(self, out) -> None:
        """Count the new storages among ``out`` until they are freed."""
        for t in _tensors(out):
            if not (isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode):
                continue
            st = t.untyped_storage()
            if id(st) in self.live:
                continue
            self.live[id(st)] = n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, id(st))

    def _freed(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not any(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                   for t in _tensors(args) + _tensors(kwargs)):
            return out
        if not func.is_view:
            self._allocated(out)
        ns, _, name = func._schema.name.partition("::")
        if ns == "_c10d_functional":
            if name in _FUNCTIONAL:
                self.collectives.append(
                    (_FUNCTIONAL[name], float(sum(_nbytes(t) for t in _tensors(out)))))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif func._schema.name == "repro_torch::linear_scan":
            self.flops += 2.0 * args[0].numel()
        elif func._schema.name == "repro_torch::wkv6":
            r, v = args[0], args[2]
            self.flops += 7.0 * r.numel() * v.shape[-1]
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args) + _tensors(out))
        return out


def scan_unit(cfg) -> int:
    """Layers per scan step (the A/B reconstruction unit)."""
    if cfg.family == "hybrid":
        return cfg.rnn_per_attention + 1
    return 1


def cached_scan_unit(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.rnn_per_attention + 1
    if cfg.global_every:
        return cfg.global_every
    return 1


def variant_cfg(cfg, n_units: int, unit: int):
    n = n_units * unit
    kw = {"n_layers": n}
    if cfg.family == "encdec":
        kw["encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


def _fake(meta_tree):
    """Fake tensors (under the active ``FakeTensorMode``) of a meta tree's
    shapes and dtypes."""
    return map_with_path(lambda _, t: torch.empty(t.shape, dtype=t.dtype), meta_tree)


def _local_bytes(plan: ShardingPlan, tree, spec_tree) -> int:
    """Bytes of every leaf's local shard under its spec (exact: a plan
    shards a dimension only over axes that divide it)."""
    total = 0

    def one(path, leaf):
        nonlocal total
        spec = spec_tree
        for k in path:
            spec = spec[k]
        total += leaf.numel() * leaf.element_size() // math.prod(
            plan.axis_size(e) for e in spec)

    map_with_path(one, tree)
    return total


def _train_batch_spec(plan: ShardingPlan, batch):
    """Train batch leaves are (mb, bm, ...): dim 1 over the DP axes."""
    n_dp = plan.axis_size(plan.dp_axes)

    def one(_, leaf):
        spec = [None] * len(leaf.shape)
        if leaf.shape[1] % n_dp == 0:
            spec[1] = plan.dp_axes
        return P(*spec)

    return map_with_path(one, batch)


def build_cell(arch: str, shape_name: str, mesh, cfg=None, microbatches: int | None = None
               ) -> dict:
    """The cell's step and its arguments' shapes and specs: {fn, kind, cfg,
    trees: {name: (meta tree, spec tree)}, out_spec, donated, microbatches}.
    Nothing is allocated: the trees are meta tensors.  ``microbatches``
    overrides the count ``cfg``'s depth would choose (the A/B variants
    train in the full model's microbatches)."""
    plan = ShardingPlan(mesh)
    n_dp = plan.axis_size(plan.dp_axes)
    sp = input_specs(arch, shape_name, n_dp=n_dp, cfg=cfg)
    cfg = cfg or sp["cfg"]
    shape = sp["shape"]
    if microbatches and shape.kind == "train":
        sp["batch"] = {k: v.reshape((microbatches, -1) + tuple(v.shape[2:]))
                       for k, v in sp["batch"].items()}
        sp["microbatches"] = microbatches

    params = specs_mod.params_shapes(cfg)
    serve_tp = shape.kind != "train" and cfg.serve_tp_params
    pspec = plan.param_spec(params, fsdp=not serve_tp)
    model_ax = "model" if cfg.vocab % plan.axis_size("model") == 0 else None

    if shape.kind == "train":
        opt = specs_mod.opt_shapes(params)
        batch = sp["batch"]
        step = make_train_step(
            cfg, optim.AdamWConfig(),
            accum_spec=pspec if cfg.shard_grad_accum else None,
        )
        return dict(fn=step, kind="train", cfg=cfg,
                    trees={"params": (params, pspec),
                           "opt": (opt, plan.opt_state_spec(pspec)),
                           "batch": (batch, _train_batch_spec(plan, batch))},
                    out_spec=None, donated=("params", "opt"),
                    microbatches=sp["microbatches"])

    caches = sp["caches"]
    cspec = plan.cache_spec(caches)
    lspec = P(plan.dp_axes if shape.global_batch % n_dp == 0 else None, model_ax)
    trees = {"params": (params, pspec), "caches": (caches, cspec)}
    if shape.kind == "prefill":
        trees["batch"] = (sp["batch"], plan.batch_spec(sp["batch"]))
        return dict(fn=make_prefill_step(cfg), kind="prefill", cfg=cfg, trees=trees,
                    out_spec=lspec, donated=("caches",), microbatches=1)

    tokens = sp["batch"]["tokens"]
    trees["tokens"] = (tokens, P(plan.dp_axes if tokens.shape[0] % n_dp == 0 else None, None))
    if cfg.family == "encdec":
        enc = sp["enc_out"]
        trees["enc_out"] = (enc, P(
            plan.dp_axes if enc.shape[0] % n_dp == 0 else None, None,
            "model" if cfg.d_model % plan.axis_size("model") == 0 else None,
        ))
    return dict(fn=make_decode_step(cfg), kind="decode", cfg=cfg, trees=trees,
                out_spec=lspec, donated=("caches",), microbatches=1)


def _args(cell: dict, placed: dict) -> tuple:
    if cell["kind"] == "train":
        return placed["params"], placed["opt"], placed["batch"]
    if cell["kind"] == "prefill":
        return placed["params"], placed["batch"], placed["caches"]
    args = [placed["params"], placed["tokens"], placed["caches"]]
    if "enc_out" in placed:
        args.append(placed["enc_out"])
    return tuple(args)


def trace_cell(arch: str, shape_name: str, mesh, cfg, rules=None,
               microbatches: int | None = None) -> dict:
    """Trace one step of the cell at ``cfg``'s depth: flops, bytes and
    collectives per device, the temporary peak, the trace seconds and the
    new outputs' bytes."""
    plan = ShardingPlan(mesh)
    cell = build_cell(arch, shape_name, mesh, cfg=cfg, microbatches=microbatches)
    # the arguments' local tensors are fake; the step runs outside the fake
    # mode (tensors the model makes itself are real and small), so that
    # DTensor's propagation finds no fake mode of ours to run in
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        placed = {name: plan.place(_fake(tree), spec)
                  for name, (tree, spec) in cell["trees"].items()}
    args = _args(cell, placed)
    cost = LocalCost(fake_mode)
    t0 = time.perf_counter()
    with policy.activate(mesh, rules), cost:
        out = cell["fn"](*args)
        if cell["kind"] == "train":
            new = [out[2]]
        else:
            # the logits' layout is the step's (the reference's out_shardings)
            new = [out[0].redistribute(mesh, placements(mesh, cell["out_spec"]))]
            new += list(out[2:])
    trace_s = time.perf_counter() - t0
    new_bytes = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                    for t in _tensors(new))
    return dict(flops=cost.flops, bytes=cost.bytes,
                collectives=collective_bytes(cost.collectives), temp_bytes=float(cost.peak_bytes),
                output_bytes=float(new_bytes), trace_s=trace_s,
                microbatches=cell["microbatches"])


def apply_overrides(cfg, overrides: dict[str, str]):
    """--set key=value config overrides for §Perf variants."""
    kw = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            kw[k] = int(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def open_fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks in this process, this process
    rank 0; an open group of another size or backend is closed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(
    arch: str, shape_name: str, multi_pod: bool,
    overrides: dict[str, str] | None = None,
    rules: dict[str, str] | None = None,
) -> dict:
    open_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    plan = ShardingPlan(mesh)
    shape = SHAPES[shape_name]
    full_cfg = get(arch)
    if overrides:
        full_cfg = apply_overrides(full_cfg, overrides)
    unit = (
        scan_unit(full_cfg)
        if shape.kind == "train"
        else cached_scan_unit(full_cfg)
    )
    n_units_full = full_cfg.n_layers // unit

    # full model: the arguments' bytes, exactly, from shapes alone
    full = build_cell(arch, shape_name, mesh, cfg=full_cfg)
    arg_bytes = {name: _local_bytes(plan, tree, spec)
                 for name, (tree, spec) in full["trees"].items()}

    # A/B variants for whole-program reconstruction
    mb = full["microbatches"]
    c1 = trace_cell(arch, shape_name, mesh, variant_cfg(full_cfg, 1, unit), rules, mb)
    c2 = trace_cell(arch, shape_name, mesh, variant_cfg(full_cfg, 2, unit), rules, mb)

    def recon(a: float, b: float) -> float:
        return a + max(b - a, 0.0) * (n_units_full - 1)

    cost = {k: recon(c1[k], c2[k]) for k in ("flops", "bytes")}
    coll = {k: recon(c1["collectives"][k], c2["collectives"][k]) for k in c1["collectives"]}
    temp = recon(c1["temp_bytes"], c2["temp_bytes"])
    argument = float(sum(arg_bytes.values()))
    alias = float(sum(arg_bytes[n] for n in full["donated"]))
    peak = argument + temp
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": 512 if multi_pod else 256,
        "overrides": overrides or {},
        "rules": rules or {},
        "kind": shape.kind,
        # trace seconds of the two unit variants (the port's compile)
        "compile_s": round(c1["trace_s"] + c2["trace_s"], 2),
        "trace_s": {"c1": c1["trace_s"], "c2": c2["trace_s"]},
        "memory": {
            "argument_bytes": argument,
            "argument_bytes_by_tree": arg_bytes,
            "output_bytes": c1["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_estimate_bytes": peak,
            "fits_h100": peak < hw.HBM_BYTES,
        },
        # per-device numbers, scan units re-multiplied
        "cost_per_device": cost,
        "cost_raw": {"c1": {k: c1[k] for k in ("flops", "bytes")},
                     "c2": {k: c2[k] for k in ("flops", "bytes")}},
        "collective_bytes_per_device": coll,
        "collective_note": COLLECTIVE_NOTE,
        "scan_units": n_units_full,
        "microbatches": full["microbatches"],
        "torch": torch.__version__,
    }


def _traced_cell(job: tuple) -> tuple:
    """(record or None, error text or None, seconds) of one cell, in a
    process of its own under ``--jobs``; the fake process group is closed
    after it."""
    t0 = time.time()
    try:
        return run_cell(*job), None, time.time() - t0
    except Exception as e:  # a cell's failure is its record; the run goes on
        return None, f"{e!r}\n{traceback.format_exc()}", time.time() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="", help="suffix for variant records")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="ModelConfig override")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="LOGICAL=AXIS", help="activation-sharding rule")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own (an eager "
                         "trace takes minutes a cell where the reference compiles)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    overrides = dict(kv.split("=", 1) for kv in getattr(args, "set"))
    rules = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rules[k] = None if v in ("none", "None") else v

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [
            (a, s, mp)
            for (a, s) in live_cells()
            for mp in (False, True)
        ]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]

    todo = []
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
        if args.tag:
            tag += f"__{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if args.all and os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        todo.append((tag, path, (arch, shape_name, mp, overrides, rules)))

    if args.jobs > 1 and len(todo) > 1:
        pool = multiprocessing.get_context("spawn").Pool(args.jobs, maxtasksperchild=1)
        results = pool.imap(_traced_cell, [job for _, _, job in todo])
    else:
        pool, results = None, (_traced_cell(job) for _, _, job in todo)
    failures = []
    try:
        for (tag, path, _), (rec, err, dt) in zip(todo, results):
            if rec is None:
                failures.append((tag, err.splitlines()[0]))
                print(f"[FAIL] {tag}: {err}", flush=True)
                continue
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(
                f"[ok]   {tag}  trace={rec['compile_s']}s "
                f"peak/dev={rec['memory']['peak_estimate_bytes']/2**30:.2f}GiB "
                f"t={dt:.0f}s", flush=True
            )
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    if failures:
        print(f"{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("all cells green")


if __name__ == "__main__":
    main()
