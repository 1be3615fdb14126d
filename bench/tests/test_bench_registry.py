"""A cell, a mix, a configuration and a metric are found by name: one
dropped into the benchmark's folder runs with no existing file edited.
And the run keeps JAX and the JAX package out of its process."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import run
from bench.harness import registry

ROOT = registry.ROOT


def _digest(base):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in base.rglob("*") if p.is_file()}


RAMP = """
from bench.harness import registry


class Ramp:
    # two clients at first, one more after every step, each in a closed loop
    def __init__(self, mix, vocab, seed):
        base = registry.generator("closed_loop")
        self.loop = base.make({**mix, "kind": "closed_loop"}, vocab, seed)

    def first_round(self):
        return self.loop.first_round()[:2]

    def due(self, finished, elapsed_s):
        return self.loop.due(finished + 1, elapsed_s)


def make(mix, vocab, seed):
    return Ramp(mix, vocab, seed)
"""


def test_new_cell_mix_config_and_metric_are_found_without_edits(tiny_bench):
    before = _digest(tiny_bench)
    # a configuration, a mix, a cell and a metric, each a new file
    cfg = json.loads((tiny_bench / "configs" / "smollm-360m.json").read_text())
    (tiny_bench / "configs" / "smollm-wide.json").write_text(
        json.dumps({**cfg, "name": "smollm-wide", "num_hidden_layers": 3}))
    mix = json.loads((tiny_bench / "traffic" / "chat.json").read_text())
    (tiny_bench / "traffic" / "burst.json").write_text(
        json.dumps({**mix, "kind": "ramp", "clients": 6}))
    # a new kind of arrivals is a new generator file
    (tiny_bench / "generators" / "ramp.py").write_text(RAMP)
    cell = json.loads((tiny_bench / "cells" / "smollm-chat.json").read_text())
    (tiny_bench / "cells" / "wide-burst.json").write_text(json.dumps(
        {**cell, "config": "smollm-wide", "traffic": "burst"}))
    (tiny_bench / "metrics" / "steps.serve.py").write_text(
        "def read(v):\n    return float(v.steps)\n")
    spec = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "wide-burst", "config": "smollm-wide", "traffic": "burst",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "steps.serve", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "engine host loop",
                              "moves": "out_tok_s", "workloads": ["wide-burst"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "smollm-chat" in m["workloads"]:
            m["workloads"].append("wide-burst")
    (tiny_bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    registry._benchmark.cache_clear()

    out = run.execute("wide-burst", seed=3, seconds=0.3, trace=True, device=torch.device("cpu"))
    assert out["correct"] and out["metrics"]["steps.serve"]["value"] > 0
    assert registry.cell("wide-burst")["model"]["num_hidden_layers"] == 3
    after = _digest(tiny_bench)
    assert {p: h for p, h in after.items() if p in before} == before
    registry._benchmark.cache_clear()


def test_benchmark_json_names_files_that_exist():
    spec = registry.benchmark()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert registry.load_json("configs", c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        registry.cell(w["name"])
    for m in spec["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
    for name, s in registry.spans().items():
        if s.get("work"):
            registry.load_module("work", s["work"])


def test_names_outside_the_contract_are_refused():
    with pytest.raises(ValueError):
        registry.load_json("cells", "../BENCHMARK")


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, path


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.serve", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


_CHILD = """
import sys, json, torch
sys.path[:0] = [{root!r}, {src!r}]
from bench import run
from bench.harness import registry
from pathlib import Path
registry.BENCH = Path({bench!r}); registry.ROOT = Path({bench!r}).parent
for w in ("smollm-chat", "granite-moe-chat", "smollm-train"):
    run.execute(w, 1, 0.3, True, torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tiny_bench):
    code = _CHILD.format(root=str(ROOT), src=str(ROOT / "src"), bench=str(tiny_bench))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _listed() -> str:
    """The first cell ``BENCHMARK.json`` lists."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", _listed(),
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    """With only BENCHMARK.json and bench/ (no program) a run fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path[:0] = [{r!r}]; sys.modules.pop('bench', None); "
            "from bench import run; run.execute({w!r}, 1, 0.3, False, "
            "torch.device('cpu'))").format(r=str(tmp_path), w=_listed())
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                      if k != "PYTHONPATH"})
    assert out.returncode != 0 and "repro_torch" in out.stderr
