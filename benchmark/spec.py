"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root,
the configuration file it names and the net module nets/<net>.py that the
configuration names, the traffic mix traffic/<mix>.json, its entry's
caller entries/<entry>.py and input parts inputs/<part>.py, the limits of
the comparison checks/<cell>.json, and each metric's reader
metrics/<metric>.py.  A new net, cell, entry, input part or metric is new
entries and new files; nothing here changes."""

from __future__ import annotations

import functools
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
    entries, inputs or nets), loaded from its file."""
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


def net(config: dict):
    """The configuration's net, nets/<config["net"]>.py (feedforward
    without the key).  A net module provides

      draw(config, seed, device)              the float weights, from the seed
      build(config, weights, device, engine=None, hidden_bits=None)
                                              the program's system, through
                                              its public set-up path
      reference(config, weights, device, input_rounding=None)
                                              the plain reference: posteriors,
                                              masked_posteriors, hidden, logits
      work(config, counts)                    {layer: roofline.Work} of a
                                              request's counters (caller.py)
      TINY                                    the configuration keys that
                                              shrink the net for the CPU tests

    Each net is loaded once a process, so that every lookup finds the same
    module and whatever state it keeps.
    """
    return _net(config.get("net", "feedforward"))


@functools.lru_cache(maxsize=None)
def _net(name: str):
    return module("nets", name)
