"""Where the benchmark finds its parts, by name.

Every configuration, traffic mix, cell, span and per-layer metric is a
file of its own under ``bench/``; nothing here lists them:

  * ``configs/<config>.json``   the model configuration as it is run
  * ``traffic/<traffic>.json``  a traffic mix's parameters; its ``kind``
                                names the generator that reads it
  * ``generators/<kind>.py``    a traffic generator (see ``closed_loop.py``
                                and ``pretrain.py`` for what one gives)
  * ``cells/<workload>.json``   a cell's run settings (``serve`` settings
                                of the program's engine, or ``train``)
  * ``spans/*.json``            a call into one of the program's layers that
                                the harness wraps (every file is loaded)
  * ``work/<work>.py``          the operations and bytes a wrapped call needs
  * ``metrics/<metric>.py``     a per-layer metric's reader, ``read(run)``

``BENCHMARK.json`` at the root says which metrics each cell reports.  A
later change adds a cell, a mix, a configuration or a metric by adding
files and entries; no file here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _file(kind: str, name: str, suffix: str, base: Path | None = None) -> Path:
    base = BENCH if base is None else base
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, base: Path | None = None) -> dict:
    """``<base>/<kind>/<name>.json``."""
    return json.loads(_file(kind, name, ".json", base).read_text())


def load_module(kind: str, name: str, base: Path | None = None):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots, so it
    is loaded from its path, not imported by name)."""
    path = _file(kind, name, ".py", base)
    mod_name = f"bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str, base: Path | None = None):
    """The traffic generator ``<base>/generators/<kind>.py``."""
    return load_module("generators", kind, base)


def spans(base: Path | None = None) -> dict[str, dict]:
    """Every span file under ``<base>/spans``, by its name."""
    out = {}
    base = BENCH if base is None else base
    for path in sorted((base / "spans").glob("*.json")):
        out[path.stem] = json.loads(path.read_text())
    return out


@functools.lru_cache(maxsize=4)
def _benchmark(path: str) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path | None = None) -> dict:
    """The parsed ``BENCHMARK.json``."""
    return _benchmark(str((ROOT if root is None else root) / "BENCHMARK.json"))


def workload_entry(name: str, root: Path | None = None) -> dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def end_to_end_metrics(workload: str, root: Path | None = None) -> list[dict]:
    """The end-to-end metrics ``workload`` reports: those that list it, and
    those that list no cells."""
    return [m for m in benchmark(root)["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_metrics(workload: str, root: Path | None = None) -> list[dict]:
    """The per-layer metrics ``workload`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(workload, root)}
    return [m for m in benchmark(root)["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def cell(name: str, base: Path | None = None, root: Path | None = None) -> dict:
    """A cell's settings, with its configuration and traffic mix loaded.
    The cell file and ``BENCHMARK.json`` must agree on them."""
    c = load_json("cells", name, base)
    entry = workload_entry(name, root)
    for key in ("config", "traffic", "chips"):
        if c[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} is {c[key]!r} in its file but "
                             f"{entry[key]!r} in BENCHMARK.json")
    return {**c, "name": name,
            "model": load_json("configs", c["config"], base),
            "mix": load_json("traffic", c["traffic"], base)}
