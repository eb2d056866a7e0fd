"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root,
the configuration file it names, the traffic mix traffic/<mix>.json, its
entry's caller entries/<entry>.py and input parts inputs/<part>.py, the
limits of the comparison checks/<cell>.json, and each metric's reader
metrics/<metric>.py.  A new cell, entry, input part or metric is new
entries and new files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == cell["config"]:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no configuration named {cell['config']!r} in BENCHMARK.json")


def traffic(cell: dict) -> dict:
    return json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())


def limits(cell: dict) -> dict:
    """{number: limit} of the cell's comparison."""
    checks = json.loads((HERE / "checks" / f"{cell['name']}.json").read_text())
    return {name: entry["limit"] for name, entry in checks.items()}


def metrics(spec: dict, cell: dict, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a "workloads" key
    only in the cells it lists."""
    entries = spec["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell["name"] in m.get("workloads", [cell["name"]])]


def module(kind: str, name: str):
    """The module <kind>/<name>.py of the benchmark (kind: metrics,
    entries or inputs), loaded from its file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no module {kind}/{name}.py in the benchmark")
    unique = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    mod_spec = importlib.util.spec_from_file_location(unique, path)
    loaded = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(loaded)
    return loaded


def reader(name: str):
    """The metric's reader, metrics/<name>.py (its `read(run)`)."""
    return module("metrics", name)


def caller(entry: str):
    """The caller class of a public entry, entries/<entry>.py's `CALLER`."""
    return module("entries", entry).CALLER
