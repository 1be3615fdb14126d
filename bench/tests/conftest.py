"""Shared fixtures of the benchmark's CPU tests: a benchmark directory in a
temporary folder holding tiny configurations, mixes and cells beside the
real spans, work counts and metric readers, put in place of ``bench/``.

    PYTHONPATH=src python -m pytest bench/tests -q
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench.harness import registry  # noqa: E402

TINY = {
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
    "head_dim": 16,
}


def tiny_config(name: str) -> dict:
    """A configuration file of the benchmark cut to a CPU test's size."""
    model = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    # float32, so that a tiny model's near-ties between tokens (or experts)
    # do not make the program's gap swing: the tests check the harness
    model = {**model, **TINY, "torch_dtype": "float32"}
    if model.get("num_local_experts"):
        model.update(num_local_experts=4, num_experts_per_tok=2, intermediate_size=32)
    return model


def tiny_mix(name: str) -> dict:
    mix = copy.deepcopy(json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text()))
    if mix["kind"] == "closed_loop":
        mix.update(clients=4, pool=64)
        if mix.get("shared_prefixes"):
            mix["shared_prefixes"].update(count=2, tokens=16)
        mix["prompt"].update(median=12, min=4, max=24)
        mix["output"].update(median=16, min=8, max=32)
    else:
        mix.update(seq_len=16, rows=4, microbatches=2, batches=8)
    return mix


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(json.loads((ROOT / "bench" / "cells" / f"{name}.json").read_text()))
    if "serve" in cell:
        cell["serve"].update(max_len=96)
        cell["serve"]["scheduler"].update(batch=4)
        cell["serve"]["kv"].pop("num_blocks", None)
        cell["run"].update(warmup_steps=3, trace_steps=2)
        # in float32 the program reads round-off (under 1e-4), the float8
        # control 0.03 and more
        cell["check"].update(requests=4, min_served_tokens=16, logit_gap=1e-3)
    else:
        cell["train"].update(trace_steps=1)
        # in float32 the program reads round-off, the float8 control 6e-3
        cell["check"].update(grad_gap=1e-3, change_gap=0.1)
    return cell


def _enter_metrics(spec: dict, workload: str, kind: str) -> None:
    """List ``workload`` under the metrics of its kind that
    ``unlisted_metrics.json`` keeps for a kind no listed cell has, entering
    each metric that ``BENCHMARK.json`` lacks."""
    keep = json.loads((Path(__file__).with_name("unlisted_metrics.json")).read_text())[kind]
    for group, entries in keep.items():
        have = {m["name"]: m for m in spec[group]}
        for m in entries:
            if m["name"] not in have:
                have[m["name"]] = {**m, "workloads": []}
                spec[group].append(have[m["name"]])
            have[m["name"]].setdefault("workloads", []).append(workload)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A ``bench/`` of tiny cells in ``tmp_path`` (with ``BENCHMARK.json``
    beside it), installed as the registry's; returns its path.  A cell file
    that ``BENCHMARK.json`` does not list yet is entered there, with the
    metrics of the cell it is most like (for a kind that no listed cell
    has, those ``unlisted_metrics.json`` keeps), so that it is tested too."""
    base = tmp_path / "bench"
    for kind in ("spans", "work", "metrics", "generators"):
        shutil.copytree(ROOT / "bench" / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in spec["workloads"]}
    for path in sorted((ROOT / "bench" / "cells").glob("*.json")):
        if path.stem in listed:
            continue
        cell = json.loads(path.read_text())
        like = next((w["name"] for w in spec["workloads"]
                     if ("serve" in cell) == ("serve" in registry.load_json("cells", w["name"]))),
                    None)
        spec["workloads"].append({"name": path.stem, "config": cell["config"],
                                  "traffic": cell["traffic"], "chips": cell["chips"],
                                  "why": cell["why"]})
        if like is None:
            _enter_metrics(spec, path.stem, "serve" if "serve" in cell else "train")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like is not None and like in m.get("workloads", ()):
                m["workloads"].append(path.stem)
    for kind, make in (("configs", tiny_config), ("traffic", tiny_mix), ("cells", tiny_cell)):
        (base / kind).mkdir()
        for path in (ROOT / "bench" / kind).glob("*.json"):
            (base / kind / path.name).write_text(json.dumps(make(path.stem)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(registry, "BENCH", base)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    return base
